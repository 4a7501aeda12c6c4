"""One run of one cell: set-up, the measured window, with ``trace`` a
profiled span after it, the metric readers, then the correctness check
against the reference once the program is freed.

``measure`` takes the device it is given; the command (``run.py``) gives
it the card and refuses to run without one. Tests call it on the CPU at a
tiny width, where no device metric can be read and none is reported.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import torch

from portbench.harness import check, spec, trace as tracing
from portbench.harness.entries import ENTRIES

# published dense bf16 tensor-core rate and HBM bandwidth of one H100 SXM
# (NVIDIA data sheet, at its 700 W power limit), by a name the card reports
PEAKS = {"H100": {"flops": 989e12, "bytes": 3.35e12}}


def device_peaks(device) -> dict | None:
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((p for key, p in PEAKS.items() if key in name), None)


@dataclass
class Context:
    """What a metric reader may read."""
    cell: spec.Cell
    entry: object
    window: dict
    setup_s: float
    peak_bytes: int
    peaks: dict | None
    trace: tracing.Trace | None = None
    trace_counts: dict = field(default_factory=dict)
    teacher_ms: float | None = None


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            t_start: float) -> dict:
    cuda = device.type == "cuda"
    split = [("imports", time.time() - t_start)]
    t = time.perf_counter()
    if cuda:
        torch.empty((), device=device)
        torch.cuda.synchronize(device)
    split.append(("device context", time.perf_counter() - t))
    entry = ENTRIES[cell.traffic["entry"]](cell, seed, device)
    entry.setup()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - t_start
    print("setup split: " + ", ".join(f"{name} {s:.3f} s" for name, s in split + entry.split),
          file=sys.stderr)
    window = entry.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if "step_s" in window:
        ms = sorted(1e3 * s for s in window["step_s"])
        print(f"step ms: p10 {ms[len(ms) // 10]:.2f}, p50 {ms[len(ms) // 2]:.2f}, "
              f"max {ms[-1]:.2f} over {len(ms)} steps", file=sys.stderr)
    if window["kind"] == "eval":
        entry.keep_outputs()
    ctx = Context(cell=cell, entry=entry, window=window, setup_s=setup_s, peak_bytes=peak,
                  peaks=device_peaks(device))
    if trace:
        ctx.trace = tracing.profile_span(entry.traced_work, device, entry.gap_work)
        ctx.trace_counts = entry.trace_work_count()
        if cuda:
            ctx.teacher_ms = entry.teacher_ms()
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    prog = dict(entry.checks)
    span = ctx.trace
    entry.release()
    del ctx
    t_ref = time.time()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    numbers = check.reference_numbers(cell, seed, device, prog)
    print(f"setup {setup_s:.3f} s, window {window['seconds']:.3f} s, reference "
          f"{time.time() - t_ref:.3f} s, reference peak "
          f"{torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else 0:.2f} GiB; "
          f"{numbers.get('worst_leaves', '')}", file=sys.stderr)
    correct, shown = check.verdict(numbers, cell.limits, window["failed"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if span is not None:
        dev["busy_s"], dev["window_s"] = span.busy_s, span.window_s
        result["breakdown"] = span.breakdown()
    result["checked"] = shown
    return result


def report_limits(shown: dict) -> None:
    for name, v in shown.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
