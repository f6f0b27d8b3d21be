"""A profiler trace of a short window, reduced to what the metrics read.

The window runs under ``torch.profiler`` (CPU and CUDA activities) inside a
``bench.window`` span. From the raw Kineto events it keeps: each device
operation's name, start and length; the busy time (the union of device
intervals inside the window) and the window's length; kernel launches; and
the host spans (``bench.*`` spans of the benchmark's own drivers and the
program's ``aten::`` calls) with which it names the idle gaps. The device
totals by kernel are ``chip_smoke.py``'s ``profiled_kernels``; the busy
share is its ``device_busy``, taken as a union of intervals so that
overlapping streams count once.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "bench.window"


def sync() -> None:
    """Wait for the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class Trace:
    busy_s: float
    window_s: float
    launches: int  # device kernels in the window
    units: int  # steps, frames or rounds the window ran
    by_name: Dict[str, Tuple[float, int]]  # kernel -> (device s, count)
    gaps: List[Tuple[str, float]]  # (host activity, idle s), longest first

    def device_s(self, parts: Sequence[str]) -> Optional[float]:
        """Device seconds of every kernel whose name holds one of
        ``parts``; None where none ran."""
        found = [(s, n) for k, (s, n) in self.by_name.items()
                 if any(p in k for p in parts)]
        return sum(s for s, _ in found) if found else None

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:120], s] for k, (s, _) in ops],
                "idle_gaps": [[k[:120], s] for k, s in self.gaps[:top]]}


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def _is_device(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def profile(fn: Callable[[], int]) -> Trace:
    """Run ``fn`` (which returns how many steps, frames or rounds it ran)
    once under the profiler and reduce its trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import record_function

    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        with record_function(WINDOW):
            units = fn()
            sync()
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0 = _ns(win[0], "start")
    w1 = w0 + _ns(win[0], "duration")
    dev, host = [], []
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    launches = 0
    for e in events:
        s = _ns(e, "start")
        d = _ns(e, "duration")
        if _is_device(e):
            if e.name().startswith("bench."):
                continue  # the device-side copy of a host span
            lo, hi = max(s, w0), min(s + d, w1)
            if hi <= lo:
                continue
            dev.append((lo, hi))
            rec = by_name[e.name()]
            rec[0] += d / 1e9
            rec[1] += 1
            if not e.name().startswith(("Memcpy", "Memset")):
                launches += 1
        elif e.name() != WINDOW:
            host.append((s, s + d, e.name()))
    dev.sort()
    busy, gaps = 0, []
    cur_lo, cur_hi = None, None
    last_end = w0
    for lo, hi in dev:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            if lo > last_end:
                gaps.append((last_end, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
        last_end = max(last_end, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    if w1 > last_end:
        gaps.append((last_end, w1))
    named = _name_gaps(host, gaps)
    return Trace(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9,
                 launches=launches, units=int(units),
                 by_name={k: (v[0], int(v[1])) for k, v in by_name.items()},
                 gaps=sorted(named.items(), key=lambda kv: -kv[1]))


def _name_gaps(host, gaps, named_gaps: int = 400) -> Dict[str, float]:
    """Idle seconds by what the host was doing in the middle of each gap:
    the outermost ``bench.*`` span and the innermost operation that cover
    it. The ``named_gaps`` longest gaps are named one by one; the rest are
    summed under one entry."""
    import numpy as np

    named: Dict[str, float] = defaultdict(float)
    if not gaps:
        return named
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    lo = np.array([h[0] for h in host], np.int64)
    hi = np.array([h[1] for h in host], np.int64)
    names = [h[2] for h in host]
    bench = np.array([n.startswith("bench.") for n in names], bool)
    for g_lo, g_hi in gaps[:named_gaps]:
        t = (g_lo + g_hi) // 2
        cover = np.nonzero((lo <= t) & (hi > t))[0]
        if not len(cover):
            key = "host: outside any recorded call"
        else:
            spans = cover[bench[cover]]
            outer = names[spans[np.argmin(lo[spans])]] if len(spans) else ""
            inner = names[cover[np.argmin(hi[cover] - lo[cover])]]
            key = (f"{outer} > {inner}" if outer and inner != outer
                   else outer or inner)
        named[key] += (g_hi - g_lo) / 1e9
    rest = gaps[named_gaps:]
    if rest:
        named[f"{len(rest)} shorter gaps"] += sum(b - a for a, b in rest) / 1e9
    return named


def timed_window(step: Callable[[], object], seconds: float,
                 sync_each: bool = False, host_each: bool = False
                 ) -> Tuple[int, float, List[float]]:
    """Call ``step`` back to back until ``seconds`` have passed on the host
    clock; every call that starts before then runs to its end. Returns
    (calls, seconds from the first call's start to the last one's end,
    each call's seconds: with ``sync_each`` until the card is done with it,
    with ``host_each`` until it returns)."""
    sync()
    t0 = time.perf_counter()
    n, each = 0, []
    while True:
        t_call = time.perf_counter()
        if t_call - t0 >= seconds and n:
            break
        step()
        if sync_each:
            sync()
        if sync_each or host_each:
            each.append(time.perf_counter() - t_call)
        n += 1
    sync()
    return n, time.perf_counter() - t0, each
