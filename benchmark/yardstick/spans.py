"""The program's own spans and counters over one window of a traced run:
what the ``program_span`` and ``program_counter`` readers read.

The first reader that asks runs the window, and it is kept on the
``Context`` for the others: the cell's ``trace_frames`` frames (``frame``)
or ``trace_rounds`` rounds (``next_round``) once more, after the profiled
window, inside ``dge_tpu_torch.utils.tracing``'s ``recording()`` and
without the profiler. It holds the span records (each
with its device interval, CUDA events at the span's entry and exit, so the
card's idle time between its kernels counts; None off a card), each
counter's change over the window, the window's start and end on the spans'
clock (``time.time_ns()``) and its units (frames or rounds). A program
without the tracing module gives no window, and its readers give nothing.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional

from benchmark.yardstick import trace as TR


def window(ctx) -> Optional[dict]:
    """The span window of this run (run once, on the first call)."""
    if not hasattr(ctx, "span_window"):
        ctx.span_window = run(ctx.driver, ctx.cell.traffic)
    return ctx.span_window


def run(driver, traffic: dict) -> Optional[dict]:
    try:
        from dge_tpu_torch.utils import tracing
    except ImportError:
        return None
    if "trace_rounds" in traffic:
        step, units = driver.next_round, int(traffic["trace_rounds"])
    else:
        step, units = driver.frame, int(traffic["trace_frames"])
    TR.sync()
    tracing.take()
    before = tracing.counters()
    start = time.time_ns()
    with tracing.recording():
        for _ in range(units):
            step()
        TR.sync()
    end = time.time_ns()
    taken = tracing.take()
    counters = {g: {k: v - before.get(g, {}).get(k, 0)
                    for k, v in vals.items()}
                for g, vals in taken["counters"].items()}
    return {"units": units, "spans": taken["spans"], "counters": counters,
            "start_ns": start, "end_ns": end}


def _named(w: dict, name: str) -> Optional[List[dict]]:
    """The spans called ``name`` (or, for a name ending in ``.``, starting
    with it); None where one has no device interval or none ran."""
    found = [s for s in w["spans"]
             if (s["name"].startswith(name) if name.endswith(".")
                 else s["name"] == name)]
    if not found or any(s["device_ms"] is None for s in found):
        return None
    return found


def median_per_request(ctx, name: str) -> Optional[float]:
    """The device milliseconds of the spans ``name``, summed in each request
    (a frame), median over the requests."""
    w = window(ctx)
    found = w and _named(w, name)
    if not found:
        return None
    by_request: Dict[int, float] = defaultdict(float)
    for s in found:
        by_request[s["request"]] += s["device_ms"]
    return statistics.median(by_request.values())


def sum_per_unit(ctx, name: str) -> Optional[float]:
    """The device milliseconds of the spans ``name`` over the window, per
    frame or round."""
    w = window(ctx)
    found = w and _named(w, name)
    if not found:
        return None
    return sum(s["device_ms"] for s in found) / w["units"]


def self_per_unit(ctx, name: str) -> Optional[float]:
    """The device milliseconds of the spans ``name`` less those of their
    nearest descendants with a device interval, per frame or round."""
    w = window(ctx)
    found = w and _named(w, name)
    if not found:
        return None
    children: Dict[int, List[dict]] = defaultdict(list)
    for s in w["spans"]:
        children[s["parent"]].append(s)

    def timed_below(sid: int) -> float:
        return sum(c["device_ms"] if c["device_ms"] is not None
                   else timed_below(c["id"]) for c in children[sid])

    return sum(s["device_ms"] - timed_below(s["id"])
               for s in found) / w["units"]


def counter_per_unit(ctx, group: str) -> Optional[float]:
    """The change of counter group ``group``, all keys together, over the
    window, per frame or round."""
    w = window(ctx)
    if not w or group not in w["counters"]:
        return None
    return sum(w["counters"][group].values()) / w["units"]
