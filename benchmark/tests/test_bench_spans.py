"""The span window of a traced run (yardstick/spans.py) on the CPU, at the
tiny sizes of test_bench_correctness.py: it holds the program's named spans
and the counters' changes (no device intervals off a card); the readers'
arithmetic on a window with device intervals; no window from a program
without the tracing module."""

import os
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_correctness import (RENDER, _cell,
                                                    _edit_overrides)
from benchmark.yardstick import spans

READERS = ("render.preprocess_frame_ms", "render.binning_frame_ms",
           "render.composite_frame_ms", "render.host_syncs_per_frame",
           "edit.unet_round_ms", "edit.cross_view_round_ms",
           "edit.guidance_self_ms", "edit.host_syncs_per_round")


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _window(name, overrides):
    cell = _cell(name, overrides)
    driver = harness.load_driver(cell)
    driver.setup()
    ctx = harness.Context(cell, driver, None)
    w = spans.window(ctx)
    assert spans.window(ctx) is w
    return ctx, w


def _measured(ctx, prefix):
    return {n: harness.load_reader(n).measure(ctx) for n in READERS
            if n.startswith(prefix)}


def test_render_window_holds_each_frames_spans_and_spill_reads():
    ctx, w = _window("render.blender1080", RENDER)
    frames = int(ctx.cell.traffic["trace_frames"])
    assert w["units"] == frames
    roots = [s for s in w["spans"] if s["parent"] is None]
    assert [s["name"] for s in roots] == ["render.spill_free"] * frames
    for root in roots:
        mine = {s["name"] for s in w["spans"] if s["request"] == root["id"]}
        assert mine == {"render.spill_free", "render.view",
                        "render.preprocess", "render.binning",
                        "render.composite", "sync.render.spill"}
    assert all(s["device_ms"] is None for s in w["spans"])
    assert w["start_ns"] <= roots[0]["start_ns"] <= roots[-1]["end_ns"] \
        <= w["end_ns"]
    syncs = w["counters"]["host_syncs"]
    assert syncs["render.spill"] == frames == sum(syncs.values())
    assert set(w["counters"]["render_ladder"].values()) == {0}
    assert _measured(ctx, "render.") == {
        "render.preprocess_frame_ms": None, "render.binning_frame_ms": None,
        "render.composite_frame_ms": None,
        "render.host_syncs_per_frame": 1.0}


def test_edit_window_holds_the_rounds_stages_and_host_reads():
    ctx, w = _window("edit.dge20", _edit_overrides())
    views = int(ctx.cell.traffic["views"])
    assert w["units"] == int(ctx.cell.traffic["trace_rounds"]) == 1
    names = [s["name"] for s in w["spans"]]
    assert names.count("guidance.round") == 1
    assert names.count("render.view") == views
    for n in ("vae.encode", "vae.encode_cond", "vae.decode"):
        assert names.count(n) == 1
    assert {"unet.pivot_record", "unet.pivot_reuse",
            "guidance.cross_view_state", "guidance.cfg_ddim"} <= set(names)
    (rnd,) = [s for s in w["spans"] if s["name"] == "guidance.round"]
    inside = [s for s in w["spans"] if s["request"] == rnd["id"]]
    assert {s["name"] for s in inside} >= {
        "vae.encode", "unet.pivot_reuse", "guidance.cross_view_state",
        "sync.guidance.pivot_offsets"}
    pivots = names.count("unet.pivot_record")
    syncs = w["counters"]["host_syncs"]
    assert syncs["edit.render_spill"] == views
    assert syncs["guidance.pivot_offsets"] == pivots
    assert sum(syncs.values()) == views + pivots
    assert _measured(ctx, "edit.") == {
        "edit.unet_round_ms": None, "edit.cross_view_round_ms": None,
        "edit.guidance_self_ms": None,
        "edit.host_syncs_per_round": float(views + pivots)}


def _span(i, name, parent, request, ms):
    return {"name": name, "id": i, "parent": parent, "request": request,
            "start_ns": i, "end_ns": i + 1, "device_ms": ms, "attrs": {}}


def test_readers_arithmetic_on_device_intervals():
    """Two frames: a layer's median of per-frame sums; two rounds: sums
    per round and a span's self time less its nearest timed
    descendants."""
    frames = types.SimpleNamespace(span_window={"units": 2, "spans": [
        _span(1, "render.spill_free", None, 1, None),
        _span(2, "render.view", 1, 1, 10.0),
        _span(3, "render.binning", 2, 1, 4.0),
        _span(4, "render.binning", 2, 1, 1.0),
        _span(5, "render.spill_free", None, 5, None),
        _span(6, "render.view", 5, 5, 9.0),
        _span(7, "render.binning", 6, 5, 3.0),
    ], "counters": {"host_syncs": {"render.spill": 3, "other": 1}}})
    assert spans.median_per_request(frames, "render.binning") == 4.0
    assert spans.counter_per_unit(frames, "host_syncs") == 2.0
    assert spans.median_per_request(frames, "render.composite") is None
    rounds = types.SimpleNamespace(span_window={"units": 2, "spans": [
        _span(1, "guidance.round", None, 1, 100.0),
        _span(2, "unet.pivot_record", 1, 1, 30.0),
        _span(3, "sync.guidance.pivot_offsets", 1, 1, None),
        _span(4, "guidance.cfg_ddim", 1, 1, 5.0),
        _span(5, "guidance.round", None, 5, 80.0),
        _span(6, "unet.pivot_reuse", 5, 5, 50.0),
        _span(7, "unet.plain", 5, 5, 10.0),
    ], "counters": {}})
    assert spans.sum_per_unit(rounds, "unet.") == 45.0
    assert spans.self_per_unit(rounds, "guidance.round") == (65.0 + 20.0) / 2
    assert spans.counter_per_unit(rounds, "host_syncs") is None


def test_no_window_without_the_tracing_module(monkeypatch):
    import dge_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "dge_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(dge_tpu_torch.utils, "tracing", raising=False)
    ctx = types.SimpleNamespace(driver=None, cell=types.SimpleNamespace(
        traffic={"trace_frames": 2}))
    assert spans.window(ctx) is None
    for n in READERS:
        reader = harness.load_reader(n)
        assert reader.measure(ctx) is None
        assert reader.read(types.SimpleNamespace(raw={})) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_listed_for_its_cell(name):
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    (m,) = [m for m in spec["per_layer"] if m["name"] == name]
    cell = "render.blender1080" if name.startswith("render.") else "edit.dge20"
    assert m["workloads"] == [cell]
    assert m["source"] == ("program_counter" if "host_syncs" in name
                           else "program_span")
