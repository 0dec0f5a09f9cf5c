"""The benchmark's reduction from a ``torch.profiler`` trace to numbers.

``capture`` runs a function under the profiler (CPU and CUDA activities,
CUPTI on the card) and keeps each device operation (kernel, copy, fill) and
each host operation as ``(name, start_ns, duration_ns)``. The reductions:
the device's busy time as the union of its operations' intervals (two
operations that overlap count once), device time and launches by name
pattern, the operations that took most time, and the longest idle gaps
named by the innermost host operation running at their middle.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Callable, List, NamedTuple, Tuple

Event = Tuple[str, int, int]


class Trace(NamedTuple):
    device: List[Event]
    host: List[Event]
    wall_s: float
    steps: int


def capture(fn: Callable[[], None], steps: int, synchronize: Callable[[], None]) -> Trace:
    """Trace ``fn()`` (``steps`` steps of work), waiting for the device at
    the end."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() == DeviceType.CUDA:
            # A host region's mirror on the device's timeline is no operation.
            kind = getattr(e, "activity_type", None)  # not in every torch version
            if not (e.is_user_annotation() or (kind and "annotation" in str(kind()))):
                device.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    return Trace(device, host, wall, steps)


def merged(events: List[Event]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, as sorted disjoint (start, end)."""
    spans = sorted((s, s + d) for _, s, d in events)
    out: List[Tuple[int, int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(events: List[Event]) -> float:
    return sum(e - s for s, e in merged(events)) / 1e9


def matching(events: List[Event], pattern: str) -> List[Event]:
    rx = re.compile(pattern)
    return [ev for ev in events if rx.search(ev[0])]


def device_s(events: List[Event], pattern: str) -> float:
    """Summed device seconds of the operations whose name matches."""
    return sum(d for _, _, d in matching(events, pattern)) / 1e9


def top_ops(events: List[Event], count: int = 10) -> list:
    """``[[name, seconds], ...]``: device time by operation name, largest
    first."""
    by_name: dict = {}
    for name, _, d in events:
        by_name[name] = by_name.get(name, 0) + d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[name[:200], d / 1e9] for name, d in ranked]


def idle_gaps(trace: Trace, count: int = 10) -> list:
    """``[[host operation, seconds], ...]``: the device's idle gaps between
    its first and last operation, summed by the innermost host operation
    running at each gap's middle (``idle`` where none ran), largest first."""
    busy = merged(trace.device)
    host = sorted(trace.host, key=lambda ev: ev[1])
    starts = [s for _, s, _ in host]
    by_name: dict = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) // 2
        best = None
        i = bisect.bisect_right(starts, mid)
        # The innermost running operation: the latest start still open.
        for name, s, d in reversed(host[max(0, i - 2000):i]):
            if s + d >= mid:
                best = name
                break
        key = (best or "idle")[:200]
        by_name[key] = by_name.get(key, 0) + (nxt - end)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
    return [[name, d / 1e9] for name, d in ranked]


def ms_per_step(trace: Trace, pattern: str) -> float:
    """Device milliseconds a step in the operations whose name matches."""
    return device_s(trace.device, pattern) / trace.steps * 1e3


def step_s(window: dict) -> float:
    """Seconds a step over a window with the profiler off: all its time over
    all its steps."""
    return window["seconds"] / (len(window["ok"]) * window["steps_per_request"])


def roofline_pct(trace: Trace, pattern: str, count: dict, extra: float = 0.0,
                 calls_pattern: str = None):
    """A kernel's share of its roofline, in percent: its bound (bytes or
    operations, ``counts.peaks.bound_s``) over its mean device time a call;
    ``extra`` device seconds more belong to its calls, which are the
    launches of ``calls_pattern`` (default ``pattern``). None where the
    trace holds no call."""
    from portbench.counts import peaks
    calls = len(matching(trace.device, calls_pattern or pattern))
    if not calls:
        return None
    mean = (device_s(trace.device, pattern) + extra) / calls
    bound, _ = peaks.bound_s(count["bytes"], count["ops"], count["op_rate"])
    return 100.0 * bound / mean
