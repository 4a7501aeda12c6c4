"""The port's slice as a whole: the two-stage retrieval eval of the port
against the JAX package's on one tiny in-memory dataset (uint8 clips, two
clips per video), weights carried from the JAX params. fp32 on the CPU.

The score matrices must agree to atol 2e-4 and the rank metrics must be
equal."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

import empirical_mvm_tpu.train.evaluators as jev
import empirical_mvm_torch.train.evaluators as tev
from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models.tasks import VioletRetrieval as JVioletRetrieval
from empirical_mvm_tpu.parallel.mesh import make_mesh
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models.convert import state_dict_from_flax
from empirical_mvm_torch.models.tasks import VioletRetrieval

# the tiny widths of tests/synth_data.py:125-140
BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64)
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8),
            drop_path_rate=0.0)


def _cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=12,
                         fusion=c.BertConfig(**BERT), text=c.BertConfig(**BERT),
                         swin_custom=c.SwinConfig(**SWIN))


class TinyRetrievalDataset:
    """12 captions over 6 videos, 2 clips of 2 uint8 frames each; captions
    of one video share its clips, as a RetrievalDataset's do."""

    def __init__(self, n_vid=6, per_vid=2, clips=2, t=2, s=64, x=12, seed=0):
        rs = np.random.RandomState(seed)
        video = {f"video{v}": rs.randint(0, 256, (clips, t, s, s, 3)).astype(np.uint8)
                 for v in range(n_vid)}
        self.items, self.gt_txt2vid = [], {}
        for i in range(n_vid * per_vid):
            vid = f"video{i % n_vid}"
            mask = np.ones((x,), np.int32)
            mask[rs.randint(4, x + 1):] = 0
            self.items.append({"img": video[vid],
                               "txt": rs.randint(5, BERT["vocab_size"], (x,)).astype(np.int32),
                               "mask": mask, "vid": vid, "tid": i})
            self.gt_txt2vid[i] = vid

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]


def _capture_scores(monkeypatch, module):
    seen = []
    real = module.rank_metrics

    def spy(scores, gt):
        seen.append(np.array(scores))
        return real(scores, gt)

    monkeypatch.setattr(module, "rank_metrics", spy)
    return seen


@pytest.fixture(scope="module")
def models():
    jmodel = JVioletRetrieval(config=_cfg(jcfg))
    params = jax.jit(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3), jnp.uint8),
        jnp.zeros((1, 12), jnp.int32), jnp.ones((1, 12), jnp.int32))["params"])()
    rs = np.random.RandomState(1)
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                          .astype(np.float32), params)
    tmodel = VioletRetrieval(_cfg(tcfg), device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params, tmodel.config,
                                                heads={"fc": "score_head"}))
    return jmodel, params, tmodel


def test_two_stage_eval_matches_jax(models, monkeypatch):
    jmodel, params, tmodel = models
    ds = TinyRetrievalDataset()
    j_seen = _capture_scores(monkeypatch, jev)
    t_seen = _capture_scores(monkeypatch, tev)
    # 12 x 6 = 72 pairs in chunks of 16: the tail chunk is padded
    ref = jev.retrieval_two_stage_eval(jmodel, params, ds, chunk_size=16,
                                       encode_batch=4, mesh=make_mesh(1))
    out = tev.retrieval_two_stage_eval(tmodel, ds, chunk_size=16, encode_batch=4,
                                       device="cpu")
    (js,), (ts,) = j_seen, t_seen
    assert ts.shape == js.shape == (12, 6)
    np.testing.assert_allclose(ts, js, atol=2e-4, rtol=0)
    for k in ("r1", "r5", "r10", "medr"):
        assert out[k] == ref[k], (k, out, ref)
    assert out["_clips"] == 24.0 and out["_pairs"] == 72.0
    assert out["_stage1_s"] > 0 and out["_stage2_s"] > 0


def test_two_stage_eval_scores_do_not_depend_on_batching(models, monkeypatch):
    """Encode batches that split clip groups and a chunk size that divides
    nothing give the same score matrix as one batch and one chunk."""
    _, _, tmodel = models
    ds = TinyRetrievalDataset(n_vid=4, per_vid=2, seed=2)
    seen = _capture_scores(monkeypatch, tev)
    tev.retrieval_two_stage_eval(tmodel, ds, chunk_size=5, encode_batch=3, device="cpu")
    tev.retrieval_two_stage_eval(tmodel, ds, chunk_size=32, encode_batch=8, device="cpu")
    np.testing.assert_allclose(seen[0], seen[1], atol=1e-6, rtol=0)


def test_rank_metrics_match_jax():
    rs = np.random.RandomState(7)
    s = rs.randn(40, 25).astype(np.float32)
    gt = rs.randint(0, 25, 40)
    assert tev.rank_metrics(s, gt) == jev.rank_metrics(s, gt)
    eye = tev.rank_metrics(np.eye(12), np.arange(12))
    assert eye == {"r1": 100.0, "r5": 100.0, "r10": 100.0, "medr": 1.0}


def test_eval_runs_under_inference_mode(models):
    _, _, tmodel = models
    ds = TinyRetrievalDataset(n_vid=2, per_vid=1)
    calls = []
    real = tmodel.score_pairs

    def spy(*args):
        calls.append(torch.is_inference_mode_enabled())
        return real(*args)

    tmodel.score_pairs = spy
    try:
        tev.retrieval_two_stage_eval(tmodel, ds, chunk_size=4, encode_batch=2,
                                     device="cpu")
    finally:
        del tmodel.score_pairs
    assert calls and all(calls)
