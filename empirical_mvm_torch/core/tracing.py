"""The port's one tracer: named spans at the layer boundaries of the train
steps and the evaluator, counters, and the profiler window the run loop
writes as a Chrome trace.

* :func:`span` opens a named span, a context manager. With recording off and
  no profiler running it returns one shared null context: a flag check, no
  allocation. While recording (:func:`enable`), each span keeps its name,
  its host start and end (``time.perf_counter_ns``), its parent and the
  request id of :func:`request`. Each thread keeps its own stack of open
  spans (remat runs the forward again on the autograd thread); a thread
  with none open takes the innermost one open on the main thread as parent,
  so that work on the autograd thread nests in the main thread's
  ``step.backward``. While a ``torch.profiler`` runs, a span also opens a
  profiler range of its name (:func:`_profiler_range`).
* :func:`count` adds to a counter while recording, attributed to the
  innermost span open, by the same rule. The tracer keeps one counter of its
  own, ``syncs``: while recording, ``torch.cuda.set_sync_debug_mode`` is
  ``"warn"`` and each of its warnings counts one, on whichever thread it is
  raised (a synchronising call in a backward warns on the autograd thread).
  The mode sees what torch marks as synchronising (``.item()``, copies to
  the host, ``nonzero``); an explicit ``torch.cuda.synchronize`` does not
  warn.
* :func:`collect` returns what was recorded since :func:`enable` and turns
  recording off.

Spans are kept in memory, at most ``LIMIT`` of them; those past it are
counted as dropped. The tracer adds no CUDA event and no synchronise: device
time per span comes from a profiler's trace, by the launches each span
encloses.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import warnings
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

LIMIT = 1 << 16
SYNC_WARNING = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request", "thread")

    def __init__(self, name: str, start_ns: int, parent, request, thread: int):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.request, self.thread = parent, request, thread


@dataclass
class Record:
    """What :func:`collect` returns. A span's ``parent`` is an index into
    ``spans`` (None at the top); ``counters`` maps (counter, index of the
    innermost span open when it counted, or None) to its count."""
    spans: list[Span]
    counters: dict[tuple[str, int | None], int]
    dropped: int


def _profiler_range(name: str):
    """A profiler range of ``name`` while a ``torch.profiler`` runs, else
    None.

    ``torch.autograd.profiler._is_profiler_enabled`` is the flag every
    ``torch.profiler`` session sets at its start and clears at its stop.
    Torch offers no query of a running session's activities, so the range
    is opened under a profiler of the device alone too: that session
    registers no host callback, records nothing of it, and the range costs
    about a microsecond. Under a profiler of the host it is a host event of
    ``name`` on the device events' clock. It is a function range
    (``_RecordFunctionFast``), not ``record_function``'s user annotation:
    the profiler mirrors a user annotation onto the device's timeline as an
    event that spans every kernel launched inside it, which would read as
    device activity."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return torch._C._profiler._RecordFunctionFast(name)


class _OpenSpan:
    __slots__ = ("tracer", "name", "span", "range")

    def __init__(self, tracer: "_Tracer", name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.range = _profiler_range(self.name)
        if self.range is not None:
            self.range.__enter__()
        self.span = self.tracer.open(self.name)
        return self

    def __exit__(self, *exc):
        self.tracer.close(self.span)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Tracer:
    """The process's recording state; the module functions act on one.

    Each thread keeps its own stack of open spans. A thread with no span
    open (the autograd thread in a backward) takes the main thread's
    innermost one as its spans' parent and for its counts."""

    def __init__(self):
        self.on = False
        self.request = None
        self.lock = threading.Lock()
        self._warnings = None
        self._reset()

    def _reset(self):
        self.spans: list[Span] = []
        self.counters: dict[tuple[str, Span | None], int] = {}
        self.dropped = 0
        self.stacks: dict[int, list] = {}

    def _inner(self, stack: list):
        """The innermost recorded span open on ``stack``, else on the main
        thread's stack."""
        for stacked in (stack, self.stacks.get(threading.main_thread().ident, ())):
            inner = next((s for s in reversed(stacked) if s is not None), None)
            if inner is not None:
                return inner
        return None

    def open(self, name: str):
        stack = self.stacks.setdefault(threading.get_ident(), [])
        span = Span(name, time.perf_counter_ns(), self._inner(stack), self.request,
                    threading.get_ident())
        with self.lock:
            if len(self.spans) < LIMIT:
                self.spans.append(span)
            else:
                self.dropped += 1
                span = None
        stack.append(span)
        return span

    def close(self, span):
        if span is not None:
            span.end_ns = time.perf_counter_ns()
        stack = self.stacks.get(threading.get_ident())
        if stack and stack[-1] is span:
            stack.pop()

    def count(self, name: str, n: int) -> None:
        inner = self._inner(self.stacks.get(threading.get_ident(), ()))
        with self.lock:
            self.counters[name, inner] = self.counters.get((name, inner), 0) + n

    def _warned(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            self.count("syncs", 1)
        else:
            self._showwarning(message, category, filename, lineno, file, line)

    def enable(self):
        if self.on:
            raise RuntimeError("tracing is already on")
        self._reset()
        if torch.cuda.is_available():
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
            self._showwarning = warnings.showwarning
            warnings.showwarning = self._warned
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.on = True

    def collect(self) -> Record:
        self.on = False
        if self._warnings is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._warnings.__exit__(None, None, None)
            self._warnings = None
        index = {id(s): i for i, s in enumerate(self.spans)}
        for s in self.spans:
            s.parent = None if s.parent is None else index[id(s.parent)]
        counters = {(name, None if s is None else index[id(s)]): n
                    for (name, s), n in self.counters.items()}
        record = Record(self.spans, counters, self.dropped)
        self._reset()
        return record


_TRACER = _Tracer()


def span(name: str):
    """A context manager: the span ``name`` (see the module's docstring)."""
    if _TRACER.on:
        return _OpenSpan(_TRACER, name)
    return _profiler_range(name) or _NULL


def request(i) -> None:
    """Set the request id the spans opened from now on keep (the step
    number for a step, an eval counter for an eval)."""
    _TRACER.request = i


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording."""
    if _TRACER.on:
        _TRACER.count(name, n)


def enable() -> None:
    """Start recording spans (at most ``LIMIT``) and counters."""
    _TRACER.enable()


def collect() -> Record:
    """The spans and counters recorded since :func:`enable`; recording
    stops."""
    return _TRACER.collect()


def profiler(device: torch.device) -> torch.profiler.profile:
    """A profiler of the host and, on a card, its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def write_trace(prof: torch.profiler.profile, out_dir: str) -> str:
    """Write ``prof``'s Chrome trace to ``out_dir/trace.json`` (view it in
    chrome://tracing or Perfetto)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path
