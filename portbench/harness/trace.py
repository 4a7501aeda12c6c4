"""A profiled span of a run, reduced to what the per-layer metrics read:
device time by kernel name, the union of the device's busy intervals, the
span's length, and the idle gaps named by what the host was doing.

The span runs under ``torch.profiler``; the raw Kineto events are read
(``kineto_results.events()``), which is much faster than building the
profiler's function-event tree.
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field

import torch

TOP = 10


@dataclass
class Trace:
    window_s: float                            # the profiled span, host clock
    busy_s: float                              # union of device intervals in it
    kernel_s: dict[str, float] = field(default_factory=dict)   # device s by name
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)

    def seconds_matching(self, patterns) -> float:
        """Device seconds of the kernels whose name holds one of ``patterns``."""
        return sum(s for name, s in self.kernel_s.items() if any(p in name for p in patterns))

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:TOP]]}


def _union(intervals):
    total, end = 0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def _profiled(fn, device, activities):
    from torch.profiler import profile

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return prof.profiler.kineto_results.events(), window_s


def profile_span(fn, device, gaps_fn=None) -> Trace:
    """With ``gaps_fn``, first run it with the host's operations recorded
    too, to name the idle gaps by them; that run also starts the profiler's
    machinery up in this process, outside the measured span. Then run
    ``fn()`` with the device's activity recorded (the host's is not:
    recording every host operation slows the host by half, which would
    read as device idle time)."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    gaps = []
    if gaps_fn is not None and cuda:
        events, _ = _profiled(gaps_fn, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        gaps = reduce_events(events, 0.0).idle_gaps
    main = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    trace = reduce_events(*_profiled(fn, device, main))
    trace.idle_gaps = gaps
    return trace


def reduce_events(events, window_s: float) -> Trace:
    dev, cpu = [], []
    for e in events:
        kind = str(e.device_type())
        start, dur = e.start_ns(), e.duration_ns()
        if dur <= 0:
            continue
        if kind.endswith("CUDA"):
            dev.append((start, start + dur, e.name()))
        elif kind.endswith("CPU"):
            cpu.append((start, start + dur, e.name()))
    kernel_s = collections.Counter()
    for a, b, name in dev:
        kernel_s[name] += (b - a) / 1e9
    busy_ns, merged = _union([(a, b) for a, b, _ in dev])
    return Trace(window_s=window_s, busy_s=busy_ns / 1e9, kernel_s=dict(kernel_s),
                 idle_gaps=_name_gaps(merged, cpu))


def _name_gaps(merged, cpu):
    """The gaps between busy intervals, summed by the innermost host
    operation running at each gap's middle; longest first."""
    if len(merged) < 2:
        return []
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    by_name = collections.Counter()
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        name, best = "host (no operation recorded)", None
        i = bisect.bisect_right(starts, mid)
        # the innermost covering operation is the latest-starting one that
        # still runs at mid; look back a bounded distance
        for j in range(i - 1, max(i - 4000, -1), -1):
            s, e, n = cpu[j]
            if e >= mid:
                best = s
                name = n
                break
        by_name[name] += (b - a) / 1e9
    return sorted(by_name.items(), key=lambda kv: -kv[1])
