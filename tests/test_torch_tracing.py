"""The port's spans and counters (dge_tpu_torch/utils/tracing.py) on the
CPU: tracing off keeps nothing and changes no render; on, the spans nest by
parent and share one request id per frame, on the clock of a
``torch.profiler`` trace; ``host_syncs`` counts the spill reads and
``render_ladder`` the rungs; ``launch_counts`` and ``collective_stats`` are
groups of the registry; ``trainer.trace=true`` writes the CLI's trace.
Two torch threads, as tests/test_torch_plain_repeat.py runs its calls."""

import json
import math
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from dge_tpu_torch import launch
from dge_tpu_torch.ops import cuda_build as CB
from dge_tpu_torch.ops import render as TR
from dge_tpu_torch.parallel import dist as TD
from dge_tpu_torch.scene import cameras as TC
from dge_tpu_torch.scene import gaussians as TG
from dge_tpu_torch.scene.camera_arrays import CameraArrays
from dge_tpu_torch.utils import tracing
from tests.test_torch_render import write_synthetic_capture

LAYERS = ("render.preprocess", "render.binning", "render.composite")


@pytest.fixture(autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.take()
    yield
    tracing.take()
    torch.set_num_threads(old)


def _scene(n=60):
    rng = np.random.default_rng(3)
    rot = rng.normal(size=(n, 4)).astype(np.float32)
    return TG.from_arrays(
        rng.normal(size=(n, 3)).astype(np.float32) * 0.6,
        rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.5,
        np.zeros((n, 0, 3), np.float32),
        rng.uniform(0.0, 3.0, size=(n, 1)).astype(np.float32),
        rng.uniform(-3.0, -2.0, size=(n, 3)).astype(np.float32),
        rot / np.linalg.norm(rot, axis=1, keepdims=True),
        max_sh_degree=0, device="cpu")


def _cams(k=3, size=32):
    return [CameraArrays.from_camera(TC.look_at_camera(
        np.array([4 * math.sin(0.5 * i), 0.3, -4 * math.cos(0.5 * i)]),
        np.zeros(3), fovx=math.radians(60), height=size, width=size), "cpu")
        for i in range(k)]


def _renderer(**kw):
    r = TR.SpillFreeRenderer(_scene(), torch.zeros(3), tile_px=16, **kw)
    assert r.probe(_cams()[0]) == 0
    return r


def test_tracing_off_keeps_no_record_and_makes_no_cuda_event(monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was made with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    s = tracing.span("render.view", device="cuda", frame=3)
    assert s is tracing.span("other", device="cuda")
    with s:
        pass
    r = _renderer()
    for cam in _cams():
        r(cam)
    assert tracing.take()["spans"] == []


def test_render_is_bit_for_bit_with_tracing_on_and_off():
    r = _renderer()
    off = [r(cam) for cam in _cams()]
    with tracing.recording():
        on = [r(cam) for cam in _cams()]
    assert tracing.take()["spans"]
    for (c_off, s_off), (c_on, s_on) in zip(off, on):
        assert torch.equal(c_off, c_on) and s_off == s_on == 0


def test_spans_nest_by_parent_with_one_request_a_frame():
    r = _renderer()
    with tracing.recording():
        for cam in _cams():
            r(cam)
    spans = tracing.take()["spans"]
    by_id = {s["id"]: s for s in spans}
    frames = [s for s in spans if s["name"] == "render.spill_free"]
    assert len(frames) == 3
    assert len({s["request"] for s in spans}) == 3
    for f in frames:
        assert f["parent"] is None and f["request"] == f["id"]
        mine = [s for s in spans if s["request"] == f["id"]]
        (view,) = [s for s in mine if s["name"] == "render.view"]
        assert view["parent"] == f["id"]
        assert sorted(s["name"] for s in mine if s["parent"] == view["id"]) \
            == sorted(LAYERS)
        (sync,) = [s for s in mine if s["name"] == "sync.render.spill"]
        assert sync["parent"] == f["id"]
        for s in mine:
            if s["parent"] is not None:
                p = by_id[s["parent"]]
                assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                    <= p["end_ns"]
            assert s["device_ms"] is None  # no CUDA device here
    assert [s["id"] for s in spans] == sorted(s["id"] for s in spans)


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(ev, what + "_us")()
                                              * 1000)


def test_spans_share_the_profiler_clock():
    """A span opened inside a ``record_function`` of the same name lies
    inside its event in a CPU profiler trace (1 ms of slack for the
    profiler's clock conversion; how long the scheduler holds the thread
    between the two does not matter); a ``perf_counter_ns`` stamp would
    lie on another clock, seconds away."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            with record_function("probe.clock"):
                with tracing.span("probe.clock"):
                    time.sleep(0.01)
    (mine,) = tracing.take()["spans"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe.clock"]
    start = _ns(ev, "start")
    end = start + _ns(ev, "duration")
    slack = 1e6
    assert start - slack <= mine["start_ns"] <= end + slack
    assert start - slack <= mine["end_ns"] <= end + slack
    assert mine["end_ns"] - mine["start_ns"] >= 1e7
    assert abs(time.perf_counter_ns() - start) > 1e9


def test_host_syncs_count_one_spill_read_a_frame():
    r = _renderer()
    before = dict(tracing.host_syncs)
    for cam in _cams():
        r(cam)
    got = {k: v - before.get(k, 0) for k, v in tracing.host_syncs.items()}
    assert got == {**dict.fromkeys(got, 0), "render.spill": 3}


def test_render_ladder_counts_rungs_on_a_forced_spill():
    r = TR.SpillFreeRenderer(_scene(), torch.zeros(3), tile_px=16,
                             max_per_tile=1)
    before = tracing.counters()
    with tracing.recording():
        assert r.probe(_cams()[0]) == 0
    after = tracing.counters()
    rungs = {k: v - before["render_ladder"][k]
             for k, v in after["render_ladder"].items()}
    assert rungs["cull"] == 1 and rungs["grew"] >= 1 and rungs["stuck"] == 0
    syncs = {k: v - before["host_syncs"].get(k, 0)
             for k, v in after["host_syncs"].items()}
    # one spill read a render (the rungs and the last, clean one), and the
    # attribution read on each doubling
    assert syncs["render.spill"] == rungs["cull"] + rungs["grew"] + 1
    assert syncs["render.spill_parts"] == rungs["grew"]
    spans = tracing.take()["spans"]
    assert sum(s["name"] == "sync.render.spill" for s in spans) \
        == syncs["render.spill"]
    assert r.caps["max_per_tile"] > 1 and r.tight_cull


def test_launch_counts_and_collective_stats_are_registry_groups():
    groups = tracing.counters()
    assert {"launch_counts", "collective_stats", "host_syncs",
            "render_ladder"} <= set(groups)
    assert tracing.group("launch_counts") is CB.launch_counts
    assert tracing.group("collective_stats") is TD.collective_stats
    assert groups["launch_counts"] == CB.launch_counts
    saved = (dict(CB.launch_counts), dict(TD.collective_stats))
    try:
        CB.launch_counts["pairs_composite"] += 2
        TD.collective_stats["calls"] += 1
        TD.collective_stats["seconds"] += 0.5
        tracing.reset("launch_counts", "collective_stats")
        assert set(CB.launch_counts.values()) == {0}
        assert TD.collective_stats == {"calls": 0, "seconds": 0.0}
        assert isinstance(TD.collective_stats["seconds"], float)
        CB.launch_counts["pairs_fold"] += 1
        TD.collective_stats["calls"] += 1
        CB.reset_launch_counts()
        TD.reset_collective_stats()
        assert set(CB.launch_counts.values()) == {0}
        assert TD.collective_stats["calls"] == 0
    finally:
        CB.launch_counts.update(saved[0])
        TD.collective_stats.update(saved[1])


def test_cli_trace_export_on_cpu(tmp_path):
    """``trainer.trace=true`` on the CPU train smoke writes
    ``<trial>/trace.json`` beside ``metrics.jsonl``: the edit round's and
    the renders' spans as complete events in epoch microseconds, nested
    as they ran, and the counters as counter events."""
    ply, capture = write_synthetic_capture(str(tmp_path), n_views=4)
    t0 = time.time_ns() / 1e3
    run = launch.main([
        "--train", "--smoke", "--cpu", "--gs_source", ply, "--source",
        capture, "--out", str(tmp_path / "out"), "data.height=32",
        "data.width=32", "data.max_view_num=4", "system.model_size=tiny",
        "system.guidance.camera_batch_size=2",
        "system.guidance.diffusion_steps=2",
        "system.guidance.resize_target=64", "system.edit.max_steps=1",
        "system.edit.tile_px=16", "system.edit.chunk=16",
        "trainer.trace=true"])
    t1 = time.time_ns() / 1e3
    assert tracing.span("after") is tracing.span("the run")  # off again
    assert os.path.exists(os.path.join(run.trial_dir, "metrics.jsonl"))
    with open(os.path.join(run.trial_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in spans}
    assert {"guidance.round", "vae.encode", "vae.encode_cond", "vae.decode",
            "unet.pivot_record", "unet.pivot_reuse",
            "guidance.cross_view_state", "guidance.cfg_ddim",
            "sync.guidance.pivot_offsets", "render.view",
            "sync.edit.render_spill", "sync.edit.ring_order",
            "sync.edit.frames"} <= names | set(LAYERS)
    assert set(LAYERS) <= names
    by_id = {e["args"]["id"]: e for e in spans}
    for e in spans:
        assert t0 <= e["ts"] <= e["ts"] + e["dur"] <= t1
        if e["name"].startswith(("vae.", "unet.", "guidance.c")):
            p = e
            while p["args"]["parent"] is not None:
                p = by_id[p["args"]["parent"]]
            assert p["name"] == "guidance.round"
    counters = {e["name"]: e["args"] for e in events if e["ph"] == "C"}
    # the process's counts (earlier tests of a worker's process add theirs)
    assert counters["host_syncs"]["guidance.pivot_offsets"] >= sum(
        e["name"] == "sync.guidance.pivot_offsets" for e in spans) >= 1
    assert "launch_counts" in counters and "render_ladder" in counters
