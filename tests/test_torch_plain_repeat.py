"""Every plain kernel version that a test compares with ``torch.equal``
returns one result, bit for bit, over 50 calls on one input in one process.

Between calls the check changes what a library reduction could hang its
order on: the thread count (the first and last calls at the process's own,
the others at 1 and 2 in turn) and the allocator's state (a kept temporary
of another size, so later temporaries land elsewhere). The calls between
stay at one or two threads because the suite runs in parallel workers:
there a call at eight threads waits on the other workers' threads, and
50 of them per case take minutes instead of a tenth of a second. The
plain versions reduce over pairs and pixels with ``ordered_sum`` /
``ordered_prod`` (serial scans) and otherwise use ops that are elementwise
or scan serially (``cumprod``, ``cumsum``, ``index_add_`` on the CPU), so
nothing here may move a bit. This file imports neither JAX nor the JAX
package."""

import numpy as np
import pytest
import torch

from dge_tpu_torch.ops import composite as TCMP
from dge_tpu_torch.ops import pairs_backward as TPB
from dge_tpu_torch.ops import pairs_composite as TPC
from dge_tpu_torch.ops import tiles_composite as TTC
from tests.test_torch_kernel import random_lists, random_stream

CALLS = 50


@pytest.fixture(scope="module")
def case():
    """The CPU stream of test_torch_kernel's wrapper test (4 tiles of 16 px,
    chunk 128, a sentinel tail), its row layout, a cotangent, the forward
    with its boundary T and the backward's inputs; per-tile lists over the
    same feature table."""
    rng = np.random.default_rng(0)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, 5)
    feats = [torch.from_numpy(x) for x in (m, c, r, d, o)]
    data = TPC.assemble_stream_data(torch.from_numpy(ids), *feats)
    st, ct = torch.from_numpy(starts), torch.from_numpy(counts)
    kw = dict(tiles_x=tiles_x, tile_px=16, chunk=128)
    blk_off, row_tile, n_rows = TPC.block_rows(st, ct, 128, data.shape[1])
    cot = torch.from_numpy(rng.normal(size=(4, 5, 256)).astype(np.float32))
    fwd, bt = TPC.composite_pairs_reference(
        data, st, ct, boundary_rows=(blk_off, n_rows), **kw)
    bt1, suf = TPB.pass1_reference(data, st, ct, blk_off, n_rows, cot, **kw)
    totals = TPB.row_totals_reference(data, st, ct, blk_off, row_tile, cot,
                                      bt, **kw)
    scratch, mask = TPC.rows_forward_reference(data, st, ct, blk_off,
                                               row_tile, **kw)
    grads = TPB.pass2_reference(data, st, ct, blk_off, row_tile, cot, fwd,
                                bt1, suf, **kw)
    lists, lcounts = (torch.from_numpy(x) for x in random_lists(rng, 4, 300))
    order = torch.from_numpy(rng.permutation(80).astype(np.int32))
    return dict(data=data, st=st, ct=ct, kw=kw, blk_off=blk_off,
                row_tile=row_tile, n_rows=n_rows, cot=cot, fwd=fwd, bt=bt1,
                suf=suf, totals=totals, scratch=scratch, mask=mask,
                grads=grads, ids=torch.from_numpy(ids), feats=feats,
                lists=lists, lcounts=lcounts, order=order)


def _forward(k, **extra):
    return TPC.composite_pairs_reference(k["data"], k["st"], k["ct"],
                                         **k["kw"], **extra)


PLAIN = {
    "composite_pairs_reference": lambda k: _forward(k),
    "composite_pairs_reference_boundary": lambda k: _forward(
        k, boundary_rows=(k["blk_off"], k["n_rows"])),
    "composite_pairs_reference_log_prefix": lambda k: _forward(
        k, log_prefix=True),
    "composite_pairs_stream_cpu": lambda k: TPC.composite_pairs_stream(
        k["data"], k["st"], k["ct"], **k["kw"]),
    "rows_forward_reference": lambda k: TPC.rows_forward_reference(
        k["data"], k["st"], k["ct"], k["blk_off"], k["row_tile"], **k["kw"]),
    "rows_forward_reference_log_space": lambda k: TPC.rows_forward_reference(
        k["data"], k["st"], k["ct"], k["blk_off"], k["row_tile"],
        log_space=True, **k["kw"]),
    "rows_combine_reference": lambda k: TPC.rows_combine_reference(
        k["scratch"], k["mask"], k["data"], k["st"], k["ct"], k["blk_off"],
        boundary=True, **k["kw"]),
    "pass1_reference": lambda k: TPB.pass1_reference(
        k["data"], k["st"], k["ct"], k["blk_off"], k["n_rows"], k["cot"],
        **k["kw"]),
    "row_totals_reference": lambda k: TPB.row_totals_reference(
        k["data"], k["st"], k["ct"], k["blk_off"], k["row_tile"], k["cot"],
        k["bt"], **k["kw"]),
    "suffix_reference": lambda k: TPB.suffix_reference(
        k["totals"], k["st"], k["ct"], k["blk_off"], chunk=128),
    "pass2_reference": lambda k: TPB.pass2_reference(
        k["data"], k["st"], k["ct"], k["blk_off"], k["row_tile"], k["cot"],
        k["fwd"], k["bt"], k["suf"], **k["kw"]),
    "fold_to_gaussians_cpu": lambda k: TPB.fold_to_gaussians(
        k["grads"], k["ids"], 80),
    "composite_lists": lambda k: TCMP.composite_lists(
        k["lists"], k["lcounts"], *k["feats"], tiles_x=2, tile_px=16,
        chunk=128),
    "composite_lists_order": lambda k: TCMP.composite_lists(
        k["lists"], k["lcounts"], *k["feats"], tiles_x=2, tile_px=16,
        chunk=128, order=k["order"]),
    "composite_tiles_kernel_cpu": lambda k: TTC.composite_tiles_kernel(
        TTC.feature_table(*k["feats"]), k["lists"], k["lcounts"], tiles_x=2,
        tile_px=16, chunk=128),
}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_plain_version_repeats_bit_for_bit(case, name):
    threads = torch.get_num_threads()
    fn = PLAIN[name]
    kept = []
    try:
        first = _flat(fn(case))
        assert any(float(x.float().abs().max()) > 0 for x in first), name
        for i in range(CALLS - 1):
            torch.set_num_threads(threads if i == CALLS - 2 else 1 + i % 2)
            kept.append(torch.empty(1 + (37 * i) % 1021))
            again = _flat(fn(case))
            for a, b in zip(again, first):
                assert torch.equal(a, b), f"{name}: call {i + 2} differs"
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wrapper_case():
    """The input of test_torch_kernel's wrapper test (seed 0, 4 tiles of
    16 px, chunk 128, no tail): the one on which two calls of the plain K1
    version once differed under the whole suite's run (ROADMAP.md §3)."""
    rng = np.random.default_rng(0)
    ids, starts, counts, m, c, r, d, o, tiles_x = random_stream(rng, 4, 16, 0)
    data = TPC.assemble_stream_data(*(torch.from_numpy(x)
                                      for x in (ids, m, c, r, d, o)))
    return dict(data=data, st=torch.from_numpy(starts),
                ct=torch.from_numpy(counts),
                kw=dict(tiles_x=tiles_x, tile_px=16, chunk=128))


def _at_threads(k, n):
    threads = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return TPC.composite_pairs_reference(k["data"], k["st"], k["ct"],
                                             **k["kw"])
    finally:
        torch.set_num_threads(threads)


def _at_offset(k, off):
    """The stream's features at a storage offset of ``off`` floats, so that
    every row of them starts at another phase of a 64-byte line."""
    data = k["data"]
    buf = torch.zeros(data.numel() + 16)
    moved = buf[off:off + data.numel()].view(data.shape)
    moved.copy_(data)
    return TPC.composite_pairs_reference(moved, k["st"], k["ct"], **k["kw"])


def _flushing_denormals(k):
    # PyTorch has no getter: a denormal that reads back as 0 was flushed
    was = bool(torch.tensor([1e-39]).mul(1.0).eq(0).item())
    torch.set_flush_denormal(True)
    try:
        return TPC.composite_pairs_reference(k["data"], k["st"], k["ct"],
                                             **k["kw"])
    finally:
        torch.set_flush_denormal(was)


# What could make a library compute an op another way from call to call:
# how a parallel loop splits its elements over threads (1 to 4; the
# vectorised and scalar tails of an element-wise op fall elsewhere), where
# the input lies (misaligned loads, MKL's aligned and unaligned paths) and
# the CPU's denormal mode. None moves a bit of the plain K1 version.
TRIGGERS = {
    "threads": lambda k: [_at_threads(k, n) for n in (1, 2, 3, 4)],
    "storage_offset": lambda k: [_at_offset(k, off) for off in range(1, 16)],
    "flush_denormal": lambda k: [_flushing_denormals(k)],
}


@pytest.mark.parametrize("trigger", sorted(TRIGGERS))
def test_plain_k1_repeats_under_candidate_triggers(wrapper_case, trigger):
    first = TPC.composite_pairs_reference(
        wrapper_case["data"], wrapper_case["st"], wrapper_case["ct"],
        **wrapper_case["kw"])
    for i, again in enumerate(TRIGGERS[trigger](wrapper_case)):
        assert torch.equal(again, first), f"{trigger}: call {i} differs"
