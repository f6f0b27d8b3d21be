"""Spans and counters: where a frame or an edit round spends its time.

JAX counterpart: none (the JAX package has no spans or counters).

**Spans.** ``span(name, device=None, **attrs)`` marks a stretch of the
program's work. Tracing is off by default: ``span`` then returns one shared
object that does nothing, after a single module-level check, and keeps no
record, creates no CUDA event and touches no tensor. Inside
``recording()`` (``is_recording()`` says whether the program is there) each
span keeps a record in memory:

- its name and ``attrs``;
- its start and end on ``time.time_ns()``, the clock on which
  ``torch.profiler`` stamps its events, so that the records can be laid
  over a profiler trace of the same run (``time.perf_counter_ns()`` runs on
  another clock);
- its id, and its parent's: the innermost span still open when it opened;
- a request id: a span with no parent opens a request, and its descendants
  share its id.

A span whose ``device`` is a CUDA device also records a CUDA event on the
current stream at entry and one at exit. Their elapsed time, the span's
*device interval* (idle time between its kernels included), is read by
``take()`` after one synchronise, so nothing on the hot path waits for the
card. ``take()`` returns the records and the counters as plain Python data
and clears the records.

**Counters** are always on. They live in one registry of named groups
(``group``), each a plain dict of numbers that its owner, the module that
makes the group, increments in place; this module owns ``host_syncs``
(``host_read``: host reads of device values, by site). ``reset`` zeroes
groups; ``counters`` copies them all.

``host_read(x, site, read)`` is how the render and edit paths read a device
value on the host: it calls ``read(x)`` (``int`` by default; ``.cpu()
.numpy()`` or ``.tolist()`` where a site needs those), counts
``host_syncs[site]`` and, with tracing on, is the span ``sync.<site>``,
whose host duration is how long the host waited for the card.

``write_chrome_trace`` writes what ``take`` returned in Chrome's
trace-event format (Perfetto reads it): spans as complete events in epoch
microseconds, counters as counter events. ``launch.py`` writes it as
``<trial>/trace.json`` under ``trainer.trace=true``.

Spans nest by the order in which they open and close on one thread; the
program records from its main thread only.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

_on = False
_records: List["_Span"] = []
_open: List["_Span"] = []  # entered and not yet left, innermost last
_ids = itertools.count(1)
_groups: Dict[str, dict] = {}


class _Off:
    """The span of tracing off: one shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "request", "start_ns",
                 "end_ns", "events")

    def __init__(self, name: str, attrs: dict, cuda: bool):
        self.name = name
        self.attrs = attrs
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if cuda else None)

    def __enter__(self):
        self.id = next(_ids)
        outer = _open[-1] if _open else None
        self.parent = outer.id if outer else None
        self.request = outer.request if outer else self.id
        _open.append(self)
        self.start_ns = time.time_ns()
        if self.events:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events:
            self.events[1].record()
        self.end_ns = time.time_ns()
        _open.remove(self)
        _records.append(self)
        return False


def span(name: str, device=None, **attrs):
    """A context manager marking the work ``name`` (with tracing on, a
    record; see the module's docstring). ``device``: the device the work
    runs on; a CUDA device gives the span a device interval."""
    if not _on:
        return _OFF
    return _Span(name, attrs,
                 device is not None and torch.device(device).type == "cuda")


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Tracing on for the block (and back to what it was after)."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def is_recording() -> bool:
    """Whether spans are being recorded (inside ``recording()``)."""
    return _on


def take() -> dict:
    """``{"spans": [...], "counters": {...}, "at_ns": ...}``: every span
    recorded since the last call, in the order they opened, each a dict of
    ``name``, ``id``, ``parent``, ``request``, ``start_ns``, ``end_ns``
    (``time.time_ns()``), ``device_ms`` (None without a device interval)
    and ``attrs``; a copy of every counter group; the time of the call.
    Clears the records; synchronises once if a record holds CUDA events."""
    recs = sorted(_records, key=lambda r: r.id)
    _records.clear()
    if any(r.events for r in recs):
        torch.cuda.synchronize()
    spans = [{"name": r.name, "id": r.id, "parent": r.parent,
              "request": r.request, "start_ns": r.start_ns,
              "end_ns": r.end_ns,
              "device_ms": (r.events[0].elapsed_time(r.events[1])
                            if r.events else None),
              "attrs": dict(r.attrs)} for r in recs]
    return {"spans": spans, "counters": counters(), "at_ns": time.time_ns()}


# ---- counters ----

def group(name: str, initial: Optional[dict] = None) -> dict:
    """The registry's counter group ``name``, made on the first call with
    the keys and zero values of ``initial``; its owner increments it in
    place, so the dict stays the same object for the process's life."""
    g = _groups.setdefault(name, {})
    for k, v in (initial or {}).items():
        g.setdefault(k, v)
    return g


def reset(*names: str) -> None:
    """Zero the counter groups ``names`` (every group when none is named),
    keeping their keys and the type of each value."""
    for name in names or tuple(_groups):
        g = _groups[name]
        for k in g:
            g[k] = type(g[k])()


def counters() -> Dict[str, dict]:
    """A copy of every counter group."""
    return {name: dict(g) for name, g in _groups.items()}


# host reads of device values, by site
host_syncs = group("host_syncs")


def host_read(x, site: str, read: Callable = int):
    """``read(x)``, a read of the device value ``x`` on the host, counted
    in ``host_syncs[site]``; with tracing on, the span ``sync.<site>``."""
    host_syncs[site] = host_syncs.get(site, 0) + 1
    if not _on:
        return read(x)
    with _Span("sync." + site, {}, False):
        return read(x)


# ---- export ----

def write_chrome_trace(path: str, taken: dict) -> str:
    """Write what ``take`` returned to ``path`` in Chrome's trace-event
    format: each span a complete event (``"ph": "X"``) in epoch
    microseconds, with its ids and device interval under ``args``; each
    counter group one counter event (``"ph": "C"``) at the time of the
    ``take``. Returns ``path``."""
    pid = os.getpid()
    events = []
    for s in taken["spans"]:
        args = dict(s["attrs"], id=s["id"], parent=s["parent"],
                    request=s["request"])
        if s["device_ms"] is not None:
            args["device_ms"] = s["device_ms"]
        events.append({"name": s["name"], "cat": s["name"].split(".")[0],
                       "ph": "X", "ts": s["start_ns"] / 1e3,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "pid": pid, "tid": 0, "args": args})
    for name, values in taken["counters"].items():
        if values:
            events.append({"name": name, "ph": "C",
                           "ts": taken["at_ns"] / 1e3, "pid": pid,
                           "args": dict(values)})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path
