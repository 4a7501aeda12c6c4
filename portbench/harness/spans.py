"""The program's own spans (``empirical_mvm_torch/core/tracing.py``) in a
traced run: what each span takes on the host and on the device, per step
or per eval.

The first reader that asks runs the entry's ``traced_work`` three more
times, after the measured span, and keeps the result on the context:

* with the tracer off, then on: the wall of each (the tracer's cost), and
  from the second each span's host ms and the counters, by request (the
  step or the eval that opened it);
* under ``trace._profiled`` with the host's and the device's activity: each
  device event (kernel, copy, set) is found its host runtime call by
  correlation id and goes to the innermost program span open at that
  call's start, on any thread (the backward's kernels are launched from the
  autograd thread while ``step.backward`` is open on the main one). A
  span's device ms hold its children's; what no span holds is ``(no span)``.

A step's reading is the median over the steps, an eval's the mean over the
evals. A program without the tracer gives no reading, and the readers
return None.
"""

from __future__ import annotations

import bisect
import collections
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import trace
from portbench.harness.entries import _sync

ROOTS = {"train": "step", "eval": "eval"}
NO_SPAN = "(no span)"


@dataclass
class Reading:
    kind: str
    requests: int                                     # steps or evals
    host_ms: dict[str, float] = field(default_factory=dict)
    calls: dict[str, float] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    device_ms: dict[str, float] = field(default_factory=dict)
    dropped: int = 0
    wall_off_s: float = 0.0
    wall_on_s: float = 0.0


def reading(ctx) -> Reading | None:
    """The run's reading, made by the first call."""
    if "span_reading" not in vars(ctx):
        ctx.span_reading = _read(ctx)
    return ctx.span_reading


def host_ms(ctx, kind: str, name: str):
    r = reading(ctx)
    return None if r is None or r.kind != kind else r.host_ms.get(name)


def device_ms(ctx, kind: str, name: str):
    r = reading(ctx)
    return None if r is None or r.kind != kind or not r.device_ms else r.device_ms.get(name)


def counter(ctx, kind: str, name: str):
    """A counter per request; read only on a card (``syncs`` is counted
    from CUDA's sync debug mode)."""
    r = reading(ctx)
    if r is None or r.kind != kind or ctx.entry.device.type != "cuda":
        return None
    return r.counters.get(name, 0.0)


def _wall(entry) -> float:
    _sync(entry.device)
    t = time.perf_counter()
    entry.traced_work()
    _sync(entry.device)
    return time.perf_counter() - t


def _read(ctx) -> Reading | None:
    try:
        from empirical_mvm_torch.core import tracing
    except ImportError:
        return None
    t0 = time.perf_counter()
    entry, kind = ctx.entry, ctx.window["kind"]
    root = ROOTS[kind]
    off_s = _wall(entry)
    tracing.enable()
    try:
        on_s = _wall(entry)
    finally:
        record = tracing.collect()
    r = host_reading(record, kind)
    r.wall_off_s, r.wall_on_s = off_s, on_s
    if entry.device.type == "cuda":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        events, _ = trace._profiled(entry.traced_work, entry.device, acts)
        names = {s.name for s in record.spans}
        spans, launches, device = split_events(events, names)
        r.device_ms = device_reading(spans, launches, device, root, _reducer(kind))
    print_table(r, ctx.cell.name)
    print(f"program spans read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return r


def _reducer(kind: str):
    return statistics.median if kind == "train" else statistics.fmean


def host_reading(record, kind: str) -> Reading:
    """Host ms and calls of each span name and the counters, per request
    (each request's sum; absent counts 0), over the requests' root spans."""
    root, reduce = ROOTS[kind], _reducer(kind)
    spans = record.spans
    requests = sorted({s.request for s in spans if s.name == root and s.end_ns is not None})
    ms = collections.defaultdict(lambda: dict.fromkeys(requests, 0.0))
    calls = collections.defaultdict(lambda: dict.fromkeys(requests, 0))
    for s in spans:
        if s.end_ns is None or s.request not in calls[s.name]:
            continue
        ms[s.name][s.request] += (s.end_ns - s.start_ns) / 1e6
        calls[s.name][s.request] += 1

    def root_request(i):
        while i is not None and spans[i].name != root:
            i = spans[i].parent
        return None if i is None else spans[i].request

    counts = collections.defaultdict(lambda: dict.fromkeys(requests, 0))
    for (name, i), n in record.counters.items():
        req = root_request(i)
        if req in counts[name]:
            counts[name][req] += n
    out = Reading(kind=kind, requests=len(requests), dropped=record.dropped)
    if requests:
        out.host_ms = {k: reduce(v.values()) for k, v in ms.items()}
        out.calls = {k: reduce(v.values()) for k, v in calls.items()}
        out.counters = {k: reduce(v.values()) for k, v in counts.items()}
    return out


def split_events(events, names):
    """Kineto events as three lists of tuples: program spans (start, end,
    name), host calls (correlation id, start), device events (correlation
    id, duration ns). A device event named as a program span is skipped."""
    spans, launches, device = [], {}, []
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            if e.name() in names:
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            else:
                launches.setdefault(e.correlation_id(), e.start_ns())
        elif kind.endswith("CUDA") and e.duration_ns() > 0 and e.name() not in names:
            device.append((e.correlation_id(), e.duration_ns()))
    return spans, launches, device


def device_reading(spans, launches, device, root: str, reduce) -> dict[str, float]:
    """Device ms of each span name per request (children included), and of
    ``(no span)``: each event to the innermost span open at its launch.

    ``spans`` (start, end, name) from any thread, ``launches`` correlation id
    -> the host call's start, ``device`` (correlation id, duration ns). A
    request is one ``root`` span; the innermost open span is the latest
    started of those still open, spans nesting on each thread."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]

    def innermost(t, before):
        for j in range(before - 1, -1, -1):
            if spans[j][1] >= t:
                return j
        return None

    # a span's parent: the latest started before it that ends after it
    parent = [innermost(end, i) for i, (_, end, _) in enumerate(spans)]
    roots = {i: k for k, i in enumerate(i for i, s in enumerate(spans) if s[2] == root)}
    request = []
    for i in range(len(spans)):
        while i is not None and i not in roots:
            i = parent[i]
        request.append(roots.get(i))
    totals = collections.defaultdict(lambda: [0.0] * len(roots))
    outside = 0.0
    for corr, dur in device:
        t = launches.get(corr)
        i = None if t is None else innermost(t, bisect.bisect_right(starts, t))
        if i is None or request[i] is None:
            outside += dur / 1e6
            continue
        req = request[i]
        while i is not None:
            totals[spans[i][2]][req] += dur / 1e6
            i = parent[i]
    out = {name: reduce(v) for name, v in totals.items()} if roots else {}
    out[NO_SPAN] = outside / max(len(roots), 1)
    return out


def print_table(r: Reading, cell: str) -> None:
    unit = "step" if r.kind == "train" else "eval"
    cost = 100.0 * (r.wall_on_s / r.wall_off_s - 1.0) if r.wall_off_s > 0 else float("nan")
    lines = [f"program spans, {cell}: {r.requests} {unit}s; traced work {r.wall_off_s:.3f} s "
             f"with the tracer off, {r.wall_on_s:.3f} s on ({cost:+.2f} %); "
             f"{r.dropped} spans dropped",
             f"{'span':<20} {'calls/' + unit:>11} {'host ms':>10} {'device ms':>10}"]
    for name in sorted(set(r.host_ms) | set(r.device_ms),
                       key=lambda n: (n == NO_SPAN, -r.host_ms.get(n, 0.0))):
        host = r.host_ms.get(name)
        dev = r.device_ms.get(name)
        lines.append(f"{name:<20} {r.calls.get(name, 0):>11g} "
                     f"{'' if host is None else f'{host:.3f}':>10} "
                     f"{'' if dev is None else f'{dev:.3f}':>10}")
    for name, n in sorted(r.counters.items()):
        lines.append(f"counter {name}: {n:g} per {unit}")
    print("\n".join(lines), file=sys.stderr)
