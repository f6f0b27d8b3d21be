"""Process groups, rank meshes and the collectives of the sharded steps.

JAX counterpart: the ``shard_map`` collectives the modules of
``dge_tpu/parallel/`` call (``psum``, ``pmean``, ``pmax``, tiled
``all_gather``, ``ppermute``) and ``jax.sharding.Mesh``. JAX runs one program
over a mesh of devices; here every rank runs the same code on its own
device (SPMD):

- an axis index is this rank's coordinate along a ``Mesh`` axis;
- ``psum`` / ``pmean`` / ``pmax`` are ``all_reduce_sum`` / ``all_reduce_sum``
  divided by the axis size / ``all_reduce_max``;
- a tiled ``all_gather`` is ``all_gather_cat`` (concatenation along dim 0);
- the ``ppermute`` of neighbour rows is ``halo_rows``.

The differentiable collectives (the sum and the gather) are
``torch.autograd.Function``s of this module, so that nothing depends on the
deprecated ``torch.distributed.nn``; the maximum reduces statistics only
and carries no gradient. They use only ``all_reduce`` and ``all_gather``,
which every backend takes on every device. Where the backend is gloo and
the tensor lies on a card (several ranks sharing one card), the tensor is
copied to the host for the collective and back: the route is chosen from
the backend's name.

Set-up: ``init_from_env`` reads torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK``; ``spawn_local`` starts ranks on this host (tests, the dry
run, ``chip_smoke.py``) over a file store in a temporary directory, so that
no port is taken. The device is ``cuda:LOCAL_RANK`` unless the caller asks
for the CPU; the backend is NCCL on a card and gloo on the CPU, and gloo on
a card only when the caller names it. Every group gets an explicit
``timeout``, so a rank whose peer died fails instead of hanging.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from dge_tpu_torch import resolve_device
from dge_tpu_torch.utils import tracing

TIMEOUT = datetime.timedelta(seconds=600)
# collectives since the last reset: their count and the host seconds spent
# inside the library call (waiting for peers included; with gloo on card
# tensors the host copies are outside it; NCCL returns once the collective
# is queued on the stream); a group of the tracing registry
# (utils/tracing.py)
collective_stats = tracing.group("collective_stats",
                                 {"calls": 0, "seconds": 0.0})


def reset_collective_stats() -> None:
    tracing.reset("collective_stats")


def _timed(collective, *args, **kw) -> None:
    t0 = time.perf_counter()
    collective(*args, **kw)
    collective_stats["seconds"] += time.perf_counter() - t0
    collective_stats["calls"] += 1


def default_backend(device) -> str:
    """NCCL for ranks on a card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init(backend: str, device: torch.device, timeout, **init_kw) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the NCCL backend needs ranks on a card")
    dist.init_process_group(backend, timeout=timeout, **init_kw)


def init_from_env(*, cpu: bool = False, backend: Optional[str] = None,
                  timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) and return this
    rank's device: ``cuda:LOCAL_RANK`` (raises without a card), or the CPU
    with ``cpu``."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = resolve_device("cpu" if cpu else f"cuda:{local}")
    _init(backend or default_backend(device), device, timeout,
          init_method="env://", rank=int(os.environ["RANK"]),
          world_size=int(os.environ["WORLD_SIZE"]))
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# ---- local ranks -----------------------------------------------------------

def _rank_main(rank_: int, world: int, fn: Callable, args: tuple,
               init_file: str, device: str, backend: Optional[str],
               timeout_s: float, results) -> None:
    """One spawned rank: join the group, run ``fn(device, *args)``, report
    its result or its traceback, leave the group."""
    torch.set_num_threads(1)  # the ranks share this host's cores
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank_ % torch.cuda.device_count())
    try:
        _init(backend or default_backend(dev), dev,
              datetime.timedelta(seconds=timeout_s),
              init_method=f"file://{init_file}", rank=rank_,
              world_size=world)
        try:
            results.put((rank_, True, fn(dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank_, False, traceback.format_exc()))
        raise


def spawn_local(fn: Callable, world: int, *, device="cuda",
                backend: Optional[str] = None, args: tuple = (),
                timeout: datetime.timedelta = TIMEOUT) -> List[object]:
    """Run ``fn(device, *args)`` on ``world`` new local ranks and return
    their results in rank order. ``fn`` must be importable (a module-level
    function), its arguments and result picklable. Ranks on a card take
    ``cuda:(rank % cards)``; NCCL refuses two ranks on one card, so that
    needs ``backend="gloo"``. Raises, after stopping every rank, if a rank
    fails or ``timeout`` (the groups' timeout too) passes."""
    device = resolve_device(device)
    be = backend or default_backend(device)
    if (be == "nccl" and device.type == "cuda"
            and world > torch.cuda.device_count()):
        raise ValueError(f"NCCL takes one rank a card: {world} ranks, "
                         f"{torch.cuda.device_count()} cards (name gloo)")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dge_dist_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, fn, tuple(args), os.path.join(tmp, "store"),
              str(device), backend, timeout.total_seconds(), results))
        for r in range(world)]
    got: Dict[int, Tuple[bool, object]] = {}
    try:
        for p in procs:
            p.start()
        deadline = timeout.total_seconds() + 60.0
        while len(got) < world:
            try:
                r, ok, value = results.get(timeout=deadline)
            except queue.Empty:
                missing = sorted(set(range(world)) - set(got))
                raise TimeoutError(f"spawn_local: ranks {missing} gave no "
                                   f"result in {deadline:.0f} s") from None
            got[r] = (ok, value)
            if not ok:
                break
        for p in procs:  # after a failure the peers are stopped below
            p.join(timeout=60.0 if all(ok for ok, _ in got.values())
                   else 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: v for r, (ok, v) in got.items() if not ok}
    if failed:
        raise RuntimeError("spawn_local: " + "\n".join(
            f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn_local: ranks exited with {bad}")
    return [got[r][1] for r in range(world)]


# ---- meshes ----------------------------------------------------------------

class Mesh:
    """A grid of all ranks with named axes and one process group a slice
    along each axis (``jax.sharding.Mesh``). Rank ``r`` sits at
    ``np.unravel_index(r, shape)``. Building one is a collective: every
    rank builds the same mesh at the same point. The groups are made with
    ``new_group`` rather than ``init_device_mesh``, whose groups take the
    library's default timeout unless given backend-specific options."""

    def __init__(self, shape: Sequence[int], names: Sequence[str], *,
                 timeout: datetime.timedelta = TIMEOUT):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axes {names}")
        world = world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} "
                             f"ranks; the group has {world}")
        self.shape = dict(zip(names, shape))
        self.names = tuple(names)
        me = rank()
        self.coords = dict(zip(names, (int(c) for c in
                                       np.unravel_index(me, shape))))
        grid = np.arange(world).reshape(shape)
        self._groups = {}
        for ax, name in enumerate(names):
            for ranks in np.moveaxis(grid, ax, -1).reshape(-1, shape[ax]):
                # a collective: every rank makes every group, in one order
                g = (dist.new_group([int(x) for x in ranks], timeout=timeout)
                     if world > 1 else None)
                if me in ranks:
                    self._groups[name] = g

    def size(self, axes: Union[str, Sequence[str]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (``axis_index``)."""
        return self.coords[axis]

    def group(self, axes: Union[str, Sequence[str]]):
        """The group of the ranks that differ from this one only along
        ``axes``: one axis, or every axis of the mesh (the whole group)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self._groups[axes[0]]
        if sorted(axes) != sorted(self.names):
            raise ValueError(f"a group over {axes} of a {self.names} mesh")
        return dist.group.WORLD


Group = Optional[object]  # a process group; None is the whole group


def group_size(group: Group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group: Group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


# ---- collectives ------------------------------------------------------------

def _host_staged(t: torch.Tensor, group: Group) -> bool:
    """Gloo on card tensors: the collective runs on a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(t: torch.Tensor, op, group: Group) -> torch.Tensor:
    """``op``-reduced copy of ``t`` over ``group``."""
    if group_size(group) == 1:
        return t.clone()
    if _host_staged(t, group):
        h = t.detach().cpu()
        _timed(dist.all_reduce, h, op=op, group=group)
        return h.to(t.device)
    out = t.detach().clone().contiguous()
    _timed(dist.all_reduce, out, op=op, group=group)
    return out


def _all_gather(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t.detach()[None].clone()
    staged = _host_staged(t, group)
    src = (t.detach().cpu() if staged else t.detach()).contiguous()
    if src.dtype == torch.bool:  # not every backend reduces or moves bool
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    _timed(dist.all_gather, parts, src, group=group)
    return torch.stack(parts).to(device=t.device, dtype=t.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        # psum's transpose is psum: every rank's output fed every rank's
        return _all_reduce(g, dist.ReduceOp.SUM, ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        parts = _all_gather(x, group)
        return parts.reshape((parts.shape[0] * x.shape[0],)
                             + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        # the transpose of a tiled all_gather: the cotangents summed over
        # the group (reduce_scatter), this rank's slice kept
        r = group_rank(ctx.group)
        total = _all_reduce(g, dist.ReduceOp.SUM, ctx.group)
        return total[r * ctx.rows:(r + 1) * ctx.rows], None


def all_reduce_sum(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``psum``: the sum over ``group`` on every rank (differentiable)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``pmean``."""
    return all_reduce_sum(x, group) / group_size(group)


def all_reduce_max(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """``pmax`` (of statistics: not differentiable)."""
    return _all_reduce(x.detach(), dist.ReduceOp.MAX, group)


def all_gather_cat(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """A tiled ``all_gather``: every rank's ``x`` concatenated along dim 0
    in group-rank order (differentiable; the backward sums the cotangents
    over the group and keeps this rank's rows). Bool and integer tensors
    pass without a gradient."""
    if not x.is_floating_point():
        parts = _all_gather(x, group)
        return parts.reshape((parts.shape[0] * x.shape[0],)
                             + tuple(x.shape[1:]))
    return _AllGatherCat.apply(x, group)


def all_gather_stack(x: torch.Tensor, group: Group = None) -> torch.Tensor:
    """An untiled ``all_gather``: ``[n, *x.shape]`` (differentiable)."""
    return all_gather_cat(x[None], group)


def halo_rows(x: torch.Tensor, group: Group, pad: int) -> torch.Tensor:
    """``x`` [rows, ...] with ``pad`` rows of each neighbouring band along
    ``group`` before and after it, zeros at the outermost edges (the zero
    "same" padding of ``losses.ssim`` at the image border, so a windowed
    metric over the extended band equals the whole image's on its rows).
    The counterpart of ``_halo_rows``'s two ``ppermute``s
    (``tile_shard.py:239-251``): one all-gather of every band's top and
    bottom ``pad`` rows, from which each rank takes its neighbours'."""
    n = group_size(group)
    z = torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if n == 1:
        return torch.cat([z, x, z], dim=0)
    i = group_rank(group)
    edges = all_gather_cat(torch.cat([x[:pad], x[-pad:]], dim=0), group)
    edges = edges.reshape((n, 2, pad) + tuple(x.shape[1:]))
    top = edges[i - 1, 1] if i > 0 else z  # band i-1's bottom rows
    bot = edges[i + 1, 0] if i < n - 1 else z  # band i+1's top rows
    return torch.cat([top, x, bot], dim=0)
