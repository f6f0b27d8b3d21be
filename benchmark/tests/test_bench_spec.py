"""BENCHMARK.json and the files it names keep to the benchmark's contract,
and a new cell, traffic mix and per-layer metric need new files only."""

import hashlib
import json
import os
import re
import shutil

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
ONE_LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def names(s):
    yield from (c["name"] for c in s["configs"])
    yield from (w["name"] for w in s["workloads"])
    yield from (m["name"] for m in s["end_to_end"] + s["per_layer"])
    for w in s["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in s["configs"]:
        yield from c["reduced"]


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_paths_and_command():
    s = spec()
    assert 1 <= len(s["paths"]) <= 16
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(s["command"]) <= 32
    for word in s["command"]:
        assert ONE_LINE.match(word)
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + "/") for p in s["paths"])


@pytest.mark.parametrize("name", sorted(set(names(spec()))))
def test_every_name_keeps_to_its_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", spec()["end_to_end"] + spec()["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric(metric):
    s = spec()
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in s["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in s["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert ONE_LINE.match(metric["layer"])
        moves = {m["name"]: m for m in s["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           metric["name"] + ".py"))


def test_names_unique_and_cells_complete():
    s = spec()
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in s[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(ms) == len(set(ms))
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert "setup_s" in ms
    four = sum(w["chips"] == 4 for w in s["workloads"])
    assert four <= max(1, len(s["workloads"]) // 4)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and ONE_LINE.match(w["why"])
        e2e = [m["name"] for m in s["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]])
                   for m in s["per_layer"])
        bench = os.path.join(ROOT, "benchmark")
        assert os.path.exists(os.path.join(bench, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(bench, "limits",
                                           w["name"] + ".json"))


def test_configs():
    s = spec()
    used = {w["config"] for w in s["workloads"]}
    files = [c["file"] for c in s["configs"]]
    assert len(files) == len(set(files))
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert ONE_LINE.match(c["source"]) and ONE_LINE.match(c["why"])
        assert any(c["file"].startswith(p + "/") for p in s["paths"])
        assert len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert "assumed" in body and body["source"] == c["source"]


def test_run_seconds_fit_the_check_with_24_cells():
    rs = spec()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _digest(root):
    out = {}
    for d, _, fs in os.walk(os.path.join(root, "benchmark")):
        for f in fs:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_and_metric_are_new_files_only(tmp_path):
    """A throwaway traffic mix, cell, limits and per-layer reader, added as
    files beside the others, are found by name and run; no file the
    benchmark already has changes."""
    from benchmark import harness

    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(root)
    s = spec()
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "traffic", "tiny_orbit.json"), "w") as f:
        json.dump({"driver": "render", "height": 24, "width": 40,
                   "orbit_frames": 6, "checked": 2, "checked_among": 3,
                   "warmup_frames": 1, "trace_frames": 2}, f)
    with open(os.path.join(bench, "limits", "render.tiny.json"), "w") as f:
        json.dump({"frame_mean_gap": 1e-3}, f)
    with open(os.path.join(bench, "metrics", "render.tiny_frames.py"),
              "w") as f:
        f.write("def read(ctx):\n    return float(ctx.trace.units)\n")
    s["workloads"].append({"name": "render.tiny", "config": "gs-blender800-sh3",
                           "traffic": "tiny_orbit", "chips": 1, "why": "test"})
    for m in s["end_to_end"]:
        if m["name"] in ("render_fps", "render_ms_p95"):
            m["workloads"].append("render.tiny")
    s["per_layer"].append({"name": "render.tiny_frames", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "test", "moves": "render_fps",
                           "workloads": ["render.tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    cell = harness.load_cell("render.tiny", 7, 0.2, True, "cpu", root=root,
                             overrides={"config": {"scene_scale": 0.003}})
    assert cell.traffic["height"] == 24
    assert [m["name"] for m in cell.per_layer] == ["render.tiny_frames"]
    reader = harness.load_reader("render.tiny_frames", root=root)
    assert callable(reader.read)
    out = harness.run_cell(cell)
    assert out["metrics"]["render.tiny_frames"]["value"] == 2.0
    assert out["correct"] and list(out)[-1] == "checks"
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
