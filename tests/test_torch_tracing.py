"""The port's tracer (``empirical_mvm_torch/core/tracing.py``) and the
benchmark's reduction of its spans (``portbench/harness/spans.py``).

CPU tests: off, the tracer records nothing and ``span`` is one shared null
context; on, it keeps nesting, parents and request ids across threads; under
a profiler of the host the span names sit on the profiler's timeline as
host events (function ranges, not user annotations: the profiler mirrors a
user annotation onto the device's timeline, where it would read as device
activity); the attribution puts each device event with the innermost span
open at its launch; a tiny pretrain step and a tiny retrieval eval are bit
for bit the same with the tracer on and off. One case, marked ``cuda``,
counts planted synchronises on the card; this file imports no JAX, so it
runs there with ``--noconftest``.
"""

import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

try:
    from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)
except ModuleNotFoundError:     # a machine whose site-packages hold a package named tests
    pass

from empirical_mvm_torch.core import config as c
from empirical_mvm_torch.core import tracing
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval
from empirical_mvm_torch.train.optimizer import AdamW
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from portbench.harness import spans as bench_spans

BERT = dict(vocab_size=1100, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, max_position_embeddings=64)
SWIN = dict(patch_size=(2, 4, 4), embed_dim=16, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 4),
            window_size=(2, 7, 7), drop_path_rate=0.1)


def _cfg():
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN))


def _recorded(fn):
    """``fn()``'s spans and counters, the tracer off again afterwards."""
    tracing.enable()
    try:
        fn()
    finally:
        record = tracing.collect()
    return record


def test_off_records_nothing_and_span_is_one_null_context():
    assert tracing.span("step") is tracing.span("eval.h2d")
    with tracing.span("step"):
        tracing.count("syncs")
    record = tracing.collect()
    assert record.spans == [] and record.counters == {} and record.dropped == 0
    record = _recorded(lambda: None)
    assert record.spans == [] and record.counters == {}
    assert tracing.span("step") is tracing.span("step")


def test_on_keeps_nesting_parents_requests_and_threads():
    def work():
        tracing.request(7)
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.count("n", 2)

            def worker():                 # no span of its own open: nests in "a"
                with tracing.span("c"):
                    with tracing.span("d"):
                        tracing.count("n")

            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        tracing.request(8)
        with tracing.span("a"):
            tracing.count("n")
        tracing.count("n", 5)             # outside every span

    record = _recorded(work)
    s = record.spans
    assert [x.name for x in s] == ["a", "b", "c", "d", "a"]
    assert [x.parent for x in s] == [None, 0, 0, 2, None]
    assert [x.request for x in s] == [7, 7, 7, 7, 8]
    assert s[2].thread == s[3].thread != s[0].thread == s[1].thread == s[4].thread
    assert all(x.start_ns <= x.end_ns for x in s)
    assert s[0].start_ns <= s[1].start_ns and s[1].end_ns <= s[0].end_ns
    assert s[0].end_ns <= s[4].start_ns
    assert record.counters == {("n", 1): 2, ("n", 3): 1, ("n", 4): 1, ("n", None): 5}
    assert record.dropped == 0


def test_spans_past_the_limit_are_dropped_and_counts_go_to_the_recorded_parent(monkeypatch):
    def work():
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.span("c"):
                    tracing.count("n")
        with tracing.span("d"):
            tracing.count("n")

    monkeypatch.setattr(tracing, "LIMIT", 2)
    record = _recorded(work)
    assert [x.name for x in record.spans] == ["a", "b"]
    assert record.dropped == 2 and record.counters == {("n", 1): 1, ("n", None): 1}
    monkeypatch.undo()
    assert _recorded(work).dropped == 0


def test_span_names_sit_on_a_cpu_profilers_timeline():
    for on in (False, True):
        if on:
            tracing.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with tracing.span("step"):
                    with tracing.span("step.forward"):
                        torch.ones(4).sum()
        finally:
            record = tracing.collect()
        assert len(record.spans) == (2 if on else 0)
        events = {e.name(): e for e in prof.profiler.kineto_results.events()}
        step, fwd, op = events["step"], events["step.forward"], events["aten::sum"]
        for e in (step, fwd):
            assert str(e.device_type()).endswith("CPU") and not e.is_user_annotation()
        assert step.start_ns() <= fwd.start_ns() <= op.start_ns()
        assert (op.start_ns() + op.duration_ns() <= fwd.start_ns() + fwd.duration_ns()
                <= step.start_ns() + step.duration_ns())
    assert tracing.span("step") is tracing.span("step.forward")    # the profiler is gone


def test_attribution_puts_each_device_event_with_the_innermost_span_at_its_launch():
    ms = 1_000_000
    spans = [(0, 100, "step"), (10, 50, "step.forward"), (20, 30, "violet.feat"),
             (60, 90, "step.backward"),
             (62, 68, "violet.feat"),     # remat's forward again, on the autograd thread
             (200, 300, "step"), (210, 290, "step.forward")]
    launches = {1: 25, 2: 40, 3: 70, 4: 150, 5: 95, 6: 250, 7: 65}
    device = [(1, 1 * ms), (2, 2 * ms), (3, 3 * ms), (4, 4 * ms), (5, 5 * ms), (6, 6 * ms),
              (7, 7 * ms), (99, 1 * ms)]                 # 4: between the steps; 99: no launch
    got = bench_spans.device_reading(spans, launches, device, "step", statistics.fmean)
    assert got == {"step": (1 + 2 + 3 + 5 + 7 + 6) / 2, "step.forward": (1 + 2 + 6) / 2,
                   "violet.feat": (1 + 7) / 2, "step.backward": (3 + 7) / 2,
                   bench_spans.NO_SPAN: (4 + 1) / 2}


class _Event:
    """A Kineto event as ``split_events`` reads it."""

    def __init__(self, kind, name, start, dur, corr):
        self._v = (kind, name, start, dur, corr)

    def device_type(self):
        return f"DeviceType.{self._v[0]}"

    def name(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def test_split_events_keeps_spans_launches_and_device_work():
    events = [_Event("CPU", "step", 0, 100, 1), _Event("CPU", "aten::mm", 5, 20, 2),
              _Event("CPU", "cudaLaunchKernel", 10, 3, 3), _Event("CUDA", "gemm", 40, 9, 3),
              _Event("CUDA", "step", 40, 50, 1), _Event("CUDA", "empty", 45, 0, 4)]
    spans, launches, device = bench_spans.split_events(events, {"step"})
    assert spans == [(0, 100, "step")]
    assert launches == {2: 5, 3: 10}
    assert device == [(3, 9)]


def _step_run(traced: bool, steps: int = 2):
    model = VioletPretrain(_cfg(), device="cpu", seed=3)
    opt = AdamW(model, 1e-3, 10)
    state = create_train_state(model, opt)
    step = make_pretrain_train_step(model, opt)
    rs = np.random.RandomState(0)
    batch = {"img": torch.from_numpy(rs.randint(0, 256, (4, 2, 64, 64, 3)).astype(np.uint8)),
             "txt": torch.from_numpy(rs.randint(1000, 1100, (4, 8))),
             "mask": torch.ones(4, 8, dtype=torch.int64)}
    losses = []

    def run():
        nonlocal state
        for _ in range(steps):
            state, ls = step(state, batch, 11)
            losses.append({k: v.clone() for k, v in ls.items()})

    record = _recorded(run) if traced else run()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, params, record


def test_pretrain_step_is_bit_equal_with_the_tracer_on():
    ls_off, p_off, _ = _step_run(False)
    ls_on, p_on, record = _step_run(True)
    for a, b in zip(ls_off, ls_on):
        assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert set(p_off) == set(p_on) and all(torch.equal(p_off[n], p_on[n]) for n in p_off)
    s = record.spans
    steps = [i for i, x in enumerate(s) if x.name == "step"]
    assert [s[i].request for i in steps] == [0, 1]
    names = {(x.name, None if x.parent is None else s[x.parent].name) for x in s}
    assert names == {("step", None), ("step.forward", "step"), ("step.backward", "step"),
                     ("step.update", "step"), ("pretrain.masking", "step.forward"),
                     ("violet.feat", "step.forward"), ("violet.cross", "step.forward")}
    r = bench_spans.host_reading(record, "train")
    assert r.requests == 2 and r.calls["step.forward"] == 1 and r.calls["violet.cross"] == 1
    assert 0 < r.host_ms["step.forward"] < r.host_ms["step"]
    assert r.host_ms["step.forward"] + r.host_ms["step.backward"] + r.host_ms["step.update"] \
        <= r.host_ms["step"]


class _Items:
    def __init__(self, n=5, clips=2):
        rs = np.random.RandomState(1)
        self.items = [{"img": rs.randint(0, 256, (clips, 2, 64, 64, 3)).astype(np.uint8),
                       "txt": rs.randint(1000, 1100, (8,)), "mask": np.ones(8, np.int64),
                       "vid": f"v{i}", "tid": i} for i in range(n)]
        self.gt_txt2vid = {i: f"v{i}" for i in range(n)}

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def test_retrieval_eval_is_bit_equal_with_the_tracer_on():
    model = VioletRetrieval(_cfg(), device="cpu", seed=2).eval()
    score_pairs = model.score_pairs
    kept = []
    model.score_pairs = lambda *a: kept.append(score_pairs(*a)) or kept[-1]
    items = _Items()

    def run():
        kept.clear()
        out = retrieval_two_stage_eval(model, items, chunk_size=8, encode_batch=2, device="cpu")
        return out, torch.cat(kept)

    out_off, scores_off = run()
    holder = {}
    record = _recorded(lambda: holder.update(r=run()))
    out_on, scores_on = holder["r"]
    assert torch.equal(scores_off, scores_on) and scores_on.numel() == 32
    assert {k: v for k, v in out_off.items() if not k.endswith("_s")} == \
        {k: v for k, v in out_on.items() if not k.endswith("_s")}
    s = record.spans
    parents = {(x.name, None if x.parent is None else s[x.parent].name) for x in s}
    assert parents == {("eval", None), ("eval.stage1", "eval"), ("eval.stage2", "eval"),
                       ("eval.stack", "eval.stage1"), ("eval.h2d", "eval.stage1"),
                       ("violet.cross", "eval.stage2")}
    r = bench_spans.host_reading(record, "eval")
    assert r.requests == 1 and r.calls["eval.stack"] == r.calls["eval.h2d"] == 9   # 3 batches
    assert r.calls["violet.cross"] == 4 and r.host_ms["eval.stack"] > 0


@pytest.mark.cuda
def test_planted_item_counts_one_sync():
    """A planted ``.item()`` in a span counts one ``syncs`` there; one in an
    autograd Function's backward, raised on the autograd thread, counts in
    the main thread's innermost span; an explicit synchronise counts none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA's sync debug mode has no CPU mode")

    class Planted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a):
            return a * 2

        @staticmethod
        def backward(ctx, g):
            g.sum().item()
            return g * 2

    x = torch.ones(8, device="cuda")
    a = torch.ones(8, device="cuda", requires_grad=True)
    torch.cuda.synchronize()

    def work():
        with tracing.span("step"):
            with tracing.span("step.forward"):
                x.sum().item()
                y = Planted.apply(a).sum()
            with tracing.span("step.backward"):
                y.backward()
            torch.cuda.synchronize()

    record = _recorded(work)
    assert [x.name for x in record.spans] == ["step", "step.forward", "step.backward"]
    assert record.counters == {("syncs", 1): 1, ("syncs", 2): 1}
    assert torch.cuda.get_sync_debug_mode() == 0
