"""The port's checkpoint I/O against the JAX package on the CPU: its msgpack
codec against ``msgpack`` and ``flax.serialization``, the flax layout both
ways (``state_dict_from_flax`` / ``flax_from_state_dict``) for every model
family the port builds, checkpoints crossing between the packages in both
directions, the scan layouts, the lenient loads (``_overlay``,
``load_torch_violet_ckpt``, the SwinBERT remap, the 2D -> 3D inflation) and
the resumable train state.

The JAX trees are ``jax.eval_shape`` of each JAX model's ``init`` (no
compile), filled from a seed (LayerNorm scales around 1), so their
structure is the JAX package's own; the port model of the same family loads
``state_dict_from_flax`` of the tree strictly. Models are tiny: a Video
Swin at embed 8, depths 1/1/1/1, a 2-layer BERT of hidden 32, 2 frames of
64^2.
"""

import functools
import os

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp
from flax import serialization

from empirical_mvm_tpu.cli import common as jcommon
from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import bert as jbert
from empirical_mvm_tpu.models import captioning as jcap
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.models import torch_import as jti
from empirical_mvm_tpu.models import video_swin as jswin
from empirical_mvm_tpu.teachers import clip as jclip
from empirical_mvm_tpu.teachers import dpt as jdpt
from empirical_mvm_tpu.teachers import dvae as jdvae
from empirical_mvm_tpu.teachers import raft as jraft
from empirical_mvm_tpu.train import checkpoint as jckpt
from empirical_mvm_torch.cli import common as tcommon
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.core import msgpack as tmsgpack
from empirical_mvm_torch.models import captioning as tcap
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models import encoders2d as tenc
from empirical_mvm_torch.models import pretrain as tpretrain
from empirical_mvm_torch.models import tasks as ttasks
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.teachers import clip as tclip
from empirical_mvm_torch.teachers import dpt as tdpt
from empirical_mvm_torch.teachers import dvae as tdvae
from empirical_mvm_torch.teachers import raft as traft
from empirical_mvm_torch.train import checkpoint as tckpt
from empirical_mvm_torch.train.optimizer import build_optimizer
from empirical_mvm_torch.train.train_step import create_train_state, make_supervised_train_step

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64)
SWIN = dict(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 4, 8), drop_path_rate=0.0)
B, O, X = 2, 3, 8
SIZE_VOCAB = 7
TEACHER_2D = (16, (2, 2, 1, 1), (1, 2, 4, 8))     # the 2D teacher shrunk in both packages
DPT_TINY = dict(vit_dim=96, vit_heads=2, vit_depth=4, hooks=(0, 1, 2, 3),
                reassemble_features=(16, 32, 48, 48), features=32, train_grid=6)
DVAE_TINY = dict(n_hid=16, n_blk_per_group=1, vocab_size=64)
CLIP_TINY = (48, 2, 4, 96)
SCORE, MLM = {"fc": "score_head"}, {"fc_mtm": "mlm_head"}


def model_cfg(c, **kw):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=X, size_option=O,
                         size_vocab=SIZE_VOCAB, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), swin_custom=c.SwinConfig(**SWIN), **kw)


def _args(txt_shape):
    return (jnp.zeros((B, 2, 64, 64, 3), jnp.uint8), jnp.zeros(txt_shape, jnp.int32),
            jnp.ones(txt_shape, jnp.int32))


def fill(shapes, seed):
    """Seeded values for an ``eval_shape`` tree: N(0, 0.05), around 1 for
    LayerNorm scales and batch-norm variances."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        base = 1.0 if path[-1].key in ("scale", "var") else 0.0
        return (base + 0.05 * rs.randn(*s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_tree(jm, args, method=None):
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "mask": jax.random.PRNGKey(2)}
    kw = {"method": method(jm)} if method else {}
    return jax.eval_shape(lambda: jm.init(rngs, *args, **kw))["params"]


# family -> (config switches, port model, JAX model, text shape, init method)
FAMILIES = {
    "retrieval": ({}, ttasks.VioletRetrieval, jtasks.VioletRetrieval, (B, X), None),
    "qamc_gumbel": ({}, functools.partial(ttasks.VioletQAMC, num_video_tokens=4),
                    functools.partial(jtasks.VioletQAMC, num_video_tokens=4), (B, O, X), None),
    "qamc_gen": ({}, ttasks.VioletQAMCGen, jtasks.VioletQAMCGen, (B, X), None),
    "qamc_mlm": ({}, ttasks.VioletQAMCMLMHead, jtasks.VioletQAMCMLMHead, (B, O, X), None),
    "qaoe": ({}, ttasks.VioletQAOE, functools.partial(jtasks.VioletQAOE, size_vocab=SIZE_VOCAB),
             (B, X), None),
    "qaoe_mlm_task_token": ({"enable_task_token": True, "task_token": "oe"},
                            ttasks.VioletQAOEMLMHead, jtasks.VioletQAOEMLMHead, (B, X), None),
    "caption": ({}, tcap.VioletCaptioning, jcap.VioletCaptioning, (B, X), None),
    "pretrain": ({}, tpretrain.VioletPretrain,
                 functools.partial(jpretrain.VioletPretrain, mvm_target=("pixel",)), (B, X),
                 lambda m: m.losses),
    "pretrain_2d_feature": ({}, functools.partial(tpretrain.VioletPretrain,
                                                  mvm_target=("2d_feature",)),
                            functools.partial(jpretrain.VioletPretrain,
                                              mvm_target=("2d_feature",),
                                              feat_target_size=TEACHER_2D[0] * 8),
                            (B, X), lambda m: m.losses),
    "pretrain_swin2d": ({"vis_backbone": "swin2d", "temporal_fusion": "concat"},
                        tpretrain.VioletPretrain,
                        functools.partial(jpretrain.VioletPretrain, mvm_target=("pixel",)),
                        (B, X), lambda m: m.losses),
}
# what the interchange through files is held on (the ISSUE's four kinds)
FILE_FAMILIES = ("retrieval", "qamc_gen", "caption", "pretrain_2d_feature")


@pytest.fixture(scope="module")
def families():
    """family -> (port model carrying the filled JAX tree, the tree)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jenc.SWIN2D_SIZES, "base", TEACHER_2D)
        mp.setitem(tenc.SWIN2D_SIZES, "base", TEACHER_2D)
        for i, (name, (kw, tm_cls, jm_cls, txt_shape, method)) in enumerate(FAMILIES.items()):
            jm = jm_cls(config=model_cfg(jcfg, **kw))
            tree = fill(jax_tree(jm, _args(txt_shape), method), seed=i)
            tm = tm_cls(model_cfg(tcfg, **kw), device="cpu")
            tm.load_state_dict(convert.state_dict_from_flax(tree))
            out[name] = (tm, tree)
    return out


def leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_tree_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), (sorted(set(g) ^ set(w)))[:10]
    for k, v in w.items():
        a, b = np.asarray(g[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def assert_sd_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ---------------------------------------------------------------- the codec

def _trees():
    scalars = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
               | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300))
    return st.recursive(scalars, lambda kids: st.lists(kids, max_size=20)
                        | st.dictionaries(st.text(max_size=8), kids, max_size=20),
                        max_leaves=60)


@settings(max_examples=200, deadline=None)
@given(_trees())
def test_codec_matches_msgpack_on_drawn_trees(obj):
    """Byte for byte what ``msgpack.packb`` writes, and what
    ``msgpack.unpackb`` reads back from it."""
    blob = msgpack.packb(obj, use_bin_type=True)
    assert tmsgpack.packb(obj) == blob
    assert tmsgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False)


@pytest.mark.parametrize("length", [0, 31, 32, 255, 256, 65535, 65536])
def test_codec_length_headers(length):
    """str, bin, array and map at the edges of their header forms."""
    for obj in ("x" * length, b"y" * length, [1] * min(length, 70000),
                {str(i): i for i in range(min(length, 70000))}):
        blob = msgpack.packb(obj, use_bin_type=True)
        assert tmsgpack.packb(obj) == blob
        assert tmsgpack.unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_codec_against_flax_on_param_trees():
    """A flax ``to_bytes`` of fp32, bf16, int32 and 0-d leaves and a numpy
    scalar reads as ``msgpack_restore`` reads it (bf16 as a
    ``torch.bfloat16`` tensor); the port writes the same bytes back, and
    ``msgpack_restore`` reads the port's bytes."""
    rs = np.random.RandomState(0)
    tree = {"enc": {"kernel": rs.randn(3, 5).astype(np.float32),
                    "bias": jnp.asarray(rs.randn(5), jnp.bfloat16)},
            "ids": rs.randint(-9, 9, (4,)).astype(np.int32), "zero_d": np.array(2.5, np.float32),
            "scalar": np.float32(1.25), "count": 7}
    blob = serialization.to_bytes(tree)
    got = tmsgpack.unpackb(bytearray(blob))
    ref = serialization.msgpack_restore(blob)
    assert isinstance(got["enc"]["bias"], torch.Tensor) and got["enc"]["bias"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["enc"]["bias"].float().numpy(),
                                  np.asarray(ref["enc"]["bias"], np.float32))
    for k in ("ids", "zero_d"):
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["enc"]["kernel"], ref["enc"]["kernel"])
    assert got["scalar"] == ref["scalar"] and type(got["scalar"]) is np.float32
    assert got["count"] == 7 and got["zero_d"].shape == ()
    assert got["ids"].flags.writeable                  # a bytearray gives writable leaves
    assert tmsgpack.packb(got) == blob
    back = serialization.msgpack_restore(tmsgpack.packb(got))
    np.testing.assert_array_equal(np.asarray(back["enc"]["bias"], np.float32),
                                  np.asarray(ref["enc"]["bias"], np.float32))
    assert back["enc"]["bias"].dtype == jnp.bfloat16


def test_codec_reads_and_writes_flax_chunked_leaves(monkeypatch):
    """A leaf above ``MAX_CHUNK_SIZE`` bytes, chunked by flax itself at a
    small limit set here, reads whole; the port chunks it the same way at
    the same limit, byte for byte."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    rs = np.random.RandomState(1)
    tree = {"big": rs.randn(7, 9).astype(np.float32), "small": np.arange(3, dtype=np.int32)}
    blob = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = tmsgpack.unpackb(blob)
    np.testing.assert_array_equal(got["big"], tree["big"])
    assert tmsgpack.packb(tree) == blob
    np.testing.assert_array_equal(serialization.msgpack_restore(tmsgpack.packb(tree))["big"],
                                  tree["big"])


def test_codec_refuses_other_ext_types():
    blob = msgpack.packb({"a": msgpack.ExtType(5, b"xyz")}, use_bin_type=True)
    with pytest.raises(tmsgpack.MsgpackError, match="ext type 5"):
        tmsgpack.unpackb(blob)
    with pytest.raises(tmsgpack.MsgpackError):
        tmsgpack.unpackb(b"\xc1")                      # never used in msgpack


# ---------------------------------------------------------------- the layout

@pytest.mark.parametrize("name", list(FAMILIES))
def test_flax_layout_round_trip(families, name):
    """``flax_from_state_dict`` is the exact inverse of
    ``state_dict_from_flax``, and of the port model's own state_dict."""
    tm, tree = families[name]
    sd = convert.state_dict_from_flax(tree)
    assert_sd_equal(sd, tm.state_dict())
    assert_tree_equal(convert.flax_from_state_dict(sd), tree)
    assert_tree_equal(convert.flax_from_state_dict(tm.state_dict()), tree)


def _teacher_trees():
    """Tiny teachers: JAX trees (``eval_shape`` filled; the 3D feature
    teacher through the JAX importer) and the port modules of the same
    geometry."""
    x = jnp.zeros((2, 64, 64, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    swin = tcfg.SwinConfig(**SWIN)
    feat = SwinTransformer3D(swin)
    sd3 = {k: v.numpy() for k, v in feat.state_dict().items()}
    trees = {
        "feature_model": (feat, jti.swin3d_params_from_torch(sd3, swin.depths)),
        "clip_model": (tclip.CLIPVisual(*CLIP_TINY, image_size=64), jax.eval_shape(
            lambda: jclip.CLIPVisual(*CLIP_TINY).init(key, x))["params"]),
        "dpt": (tdpt.DPTDepth(**DPT_TINY), jax.eval_shape(
            lambda: jdpt.DPTDepth(**DPT_TINY).init(key, x))["params"]),
        "raft": (traft.RAFT(num_updates=3), jax.eval_shape(
            lambda: jraft.RAFT(num_updates=3).init(key, x, x))["params"]),
        "dvae": (tdvae.DvaeEncoder(**DVAE_TINY), jax.eval_shape(
            lambda: jdvae.DvaeEncoder(**DVAE_TINY).init(key, x))["params"]),
    }
    return {k: (m, fill(t, seed=20 + i) if k != "feature_model" else t)
            for i, (k, (m, t)) in enumerate(trees.items())}


def test_flax_layout_round_trip_with_every_teacher(families):
    """A pretrain tree holding the 3D feature, CLIP, DPT, RAFT and dVAE
    teachers: each teacher's keys are its port module's, and the tree
    comes back exactly."""
    _, trunk = families["pretrain"]
    teachers = _teacher_trees()
    tree = {**trunk, **{k: t for k, (_, t) in teachers.items()}}
    sd = convert.state_dict_from_flax(tree)
    for name, (module, _) in teachers.items():
        mine = {k[len(name) + 1:]: v for k, v in sd.items() if k.startswith(name + ".")}
        assert set(mine) == set(module.state_dict()), name
        module.load_state_dict(mine)
    assert_tree_equal(convert.flax_from_state_dict(sd), tree)


# ------------------------------------------------------- files between packages

@pytest.mark.parametrize("suffix", [".msgpack", ".npz"])
@pytest.mark.parametrize("name", FILE_FAMILIES)
def test_jax_checkpoint_loads_into_the_port(families, name, suffix, tmp_path):
    """JAX ``save_params`` -> the port's ``load_params``: the state_dict of
    the tree, bit for bit."""
    tm, tree = families[name]
    path = str(tmp_path / f"ckpt{suffix}")
    jckpt.save_params(tree, path)
    assert_sd_equal(tckpt.load_params(path), convert.state_dict_from_flax(tree))


@pytest.mark.parametrize("suffix", [".msgpack", ".npz"])
@pytest.mark.parametrize("name", FILE_FAMILIES)
def test_port_checkpoint_loads_into_jax(families, name, suffix, tmp_path):
    """The port's ``save_params`` of the model -> JAX ``load_params``: the
    JAX tree, bit for bit, with and without the template; the meta JSON
    beside it."""
    tm, tree = families[name]
    path = str(tmp_path / f"ckpt{suffix}")
    tckpt.save_params(tm, path, meta={"epoch": 1})
    assert_tree_equal(jckpt.load_params(path), tree)
    if suffix == ".msgpack":
        assert_tree_equal(jckpt.load_params(path, like=tree), tree)
    assert os.path.exists(str(tmp_path / "ckpt.json"))


def test_torch_formats_refused(tmp_path):
    with pytest.raises(ValueError, match="load_torch_violet_ckpt"):
        tckpt.load_params(str(tmp_path / "x.pt"))
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        tckpt.save_params({}, str(tmp_path / "x.bin"))


# ---------------------------------------------------------------- scan layouts

def _stacked(tree):
    """``tree`` in the JAX scan layout: the fusion's layers stacked, each
    Swin stage's blocks in pairs (JAX's own stack functions)."""
    out = jax.tree.map(np.asarray, tree)
    out["trsfr"] = jbert.stack_encoder_params(tree["trsfr"], BERT["num_hidden_layers"])
    swin = dict(out["enc_img"]["swin"])
    for i in range(4):
        swin[f"layers_{i}"] = jswin.swin_stack_stage_blocks(swin[f"layers_{i}"], 2)
    out["enc_img"] = {**out["enc_img"], "swin": swin}
    return out


@pytest.fixture(scope="module")
def deep_retrieval():
    """A retrieval model with two blocks a Swin stage (pairs to stack)."""
    swin = dict(SWIN, depths=(2, 2, 2, 2))
    cfg_j = jcfg.ModelConfig(size_img=64, size_frame=2, size_txt=X,
                             fusion=jcfg.BertConfig(**BERT), text=jcfg.BertConfig(**BERT),
                             swin_custom=jcfg.SwinConfig(**swin))
    cfg_t = tcfg.load_run_config({"swin_custom": swin, "fusion": BERT, "text": BERT,
                                  "size_img": 64, "size_frame": 2, "size_txt": X}).model
    tree = fill(jax_tree(jtasks.VioletRetrieval(config=cfg_j), _args((B, X))), seed=40)
    return cfg_t, tree


def test_scan_stacked_checkpoints_load(deep_retrieval, tmp_path):
    """Scan-stacked BERT and Swin checkpoints written by JAX load into the
    per-layer port (``load_params``, and ``load_initial_params`` through
    ``_adapt_encoder_layout``)."""
    cfg_t, tree = deep_retrieval
    path = str(tmp_path / "scan.msgpack")
    jckpt.save_params(_stacked(tree), path)
    assert_sd_equal(tckpt.load_params(path), convert.state_dict_from_flax(tree))
    tm = ttasks.VioletRetrieval(cfg_t, device="cpu")
    run = tcfg.RunConfig(model=cfg_t, path_ckpt=path)
    report = tcommon.load_initial_params(run, tm)
    assert not report["kept"] and not report["ignored"]
    assert_sd_equal(tm.state_dict(), convert.state_dict_from_flax(tree))


@pytest.mark.parametrize("direction", ["stacked_into_per_layer", "per_layer_into_stacked"])
def test_adapt_encoder_layout_matches_jax(deep_retrieval, direction):
    """The port's ``_adapt_encoder_layout`` and stack / unstack functions
    against the JAX ones on the same trees, both ways."""
    _, tree = deep_retrieval
    flat, stacked = jax.tree.map(np.asarray, tree), _stacked(tree)
    base, loaded = (flat, stacked) if direction == "stacked_into_per_layer" else (stacked, flat)
    assert_tree_equal(tcommon._adapt_encoder_layout(base, loaded),
                      jcommon._adapt_encoder_layout(base, loaded))
    assert_tree_equal(convert.per_layer_layout(stacked), flat)


# ------------------------------------------------------------- lenient loads

def test_overlay_matches_jax(families):
    """A shape that differs, a key only the checkpoint has and a head it
    lacks: the port's ``_overlay`` merges as the JAX one, and reports
    them."""
    _, tree = families["retrieval"]
    base = jax.tree.map(np.asarray, tree)
    loaded = jax.tree.map(lambda v: v + 1.0, base)
    loaded["enc_img"] = dict(loaded["enc_img"], emb_len=loaded["enc_img"]["emb_len"][:, :1])
    loaded["extra_head"] = {"kernel": np.ones((2, 2), np.float32)}
    del loaded["fc"]
    report = {"loaded": [], "kept": [], "ignored": []}
    got = tcommon._overlay(base, loaded, report)
    assert_tree_equal(got, jax.tree.map(np.asarray, jcommon._overlay(base, loaded)))
    assert "enc_img.emb_len" in report["kept"]
    assert {p for p in report["kept"] if p.startswith("fc.")} == {
        "fc.fc1.kernel", "fc.fc1.bias", "fc.fc2.kernel", "fc.fc2.bias"}
    assert report["ignored"] == ["extra_head"]
    assert len(report["loaded"]) == len(leaves(base)) - 5


def test_load_torch_violet_ckpt_matches_jax(families, tmp_path):
    """A trainer-wrapped, ``module.``-prefixed ``.pt`` with an ``emb_len``
    longer and an ``emb_pos`` shorter than the model's: the port's
    ``load_torch_violet_ckpt`` gives the JAX importer's values (cut and
    zero-padded), in the port's names."""
    tm, _ = families["retrieval"]
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    d = sd["enc_img.emb_len"].shape[-1]
    sd["enc_img.emb_len"] = torch.randn(1, tm.config.max_size_frame + 3, 1, d)
    n_pos = sd["enc_img.emb_pos"].shape[2]
    sd["enc_img.emb_pos"] = sd["enc_img.emb_pos"][:, :, :n_pos - 3].clone()
    sd["fc_mtm.predictions.bias"] = torch.zeros(3)          # not the model's: reported
    path = str(tmp_path / "ckpt_violet.pt")
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, path)
    got = tckpt.load_torch_violet_ckpt(path, tm.config, expected=tm.state_dict())
    want = convert.state_dict_from_flax(
        jckpt.load_torch_violet_ckpt(path, model_cfg(jcfg), heads=SCORE), heads=SCORE)
    assert set(got) == set(tm.state_dict())
    assert_sd_equal(got, want)
    assert not got["enc_img.emb_pos"][:, :, n_pos - 3:].any()


def test_load_teacher_params_from_pt_and_msgpack(tmp_path, caplog):
    """A pretrain model's CLIP teacher from an HF-named ``.pt`` (the
    ``vision_model.`` prefix taken off) and from a JAX-written flax
    ``.msgpack`` (through ``clip_state_dict``); without a path the teacher
    keeps its init, with the JAX package's warning."""
    import types
    key = jax.random.PRNGKey(0)
    tree = fill(jax.eval_shape(lambda: jclip.CLIPVisual(*CLIP_TINY).init(
        key, jnp.zeros((1, 64, 64, 3))))["params"], seed=30)
    want = convert.clip_state_dict(tree)
    pt, mp = str(tmp_path / "clip.pt"), str(tmp_path / "clip.msgpack")
    torch.save({f"vision_model.{k}": v for k, v in want.items()}, pt)
    jckpt.save_params(tree, mp)
    for path in (pt, mp):
        model = types.SimpleNamespace(clip_model=tclip.CLIPVisual(*CLIP_TINY, image_size=64))
        run = tcfg.RunConfig(model=tcfg.ModelConfig(clip_model_path=path))
        tcommon.load_teacher_params(run, model)
        assert_sd_equal(model.clip_model.state_dict(), want)
    model = types.SimpleNamespace(clip_model=tclip.CLIPVisual(*CLIP_TINY, image_size=64))
    before = {k: v.clone() for k, v in model.clip_model.state_dict().items()}
    tcommon.load_teacher_params(tcfg.RunConfig(), model)
    assert_sd_equal(model.clip_model.state_dict(), before)
    assert any("RANDOM init" in r.message for r in caplog.records)


def test_remap_swinbert_keys_matches_jax():
    rs = np.random.RandomState(3)
    keys = ["swin.backbone.layers.0.blocks.0.norm1.weight",
            "trans_encoder.bert.encoder.layer.0.output.dense.bias",
            "trans_encoder.bert.embeddings.word_embeddings.weight", "fc.weight",
            "trans_encoder.bert.img_embedding.weight", "trans_encoder.cls.predictions.bias",
            "trans_encoder.cls.predictions.transform.dense.weight", "learn_vid_att.weight"]
    sd = {k: rs.randn(2, 3).astype(np.float32) for k in keys}
    got = convert.remap_swinbert_keys(sd)
    want = jti.remap_swinbert_keys(sd)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_inflate_swin2d_to_3d_matches_jax():
    """The patch kernel gains its temporal axis; a (23^2, nH) table of a
    2D window of 12 is resized bicubically to the 7 x 7 window and tiled
    over the 15 temporal offsets; the index and mask buffers are dropped."""
    rs = np.random.RandomState(4)
    sd = {"patch_embed.proj.weight": rs.randn(8, 3, 4, 4).astype(np.float32),
          "layers.0.blocks.0.attn.relative_position_bias_table":
              rs.randn(23 * 23, 2).astype(np.float32),
          "layers.0.blocks.1.attn.relative_position_bias_table":
              rs.randn(13 * 13, 2).astype(np.float32),
          "layers.0.blocks.0.attn.relative_position_index": np.zeros((49, 49), np.int64),
          "layers.0.blocks.1.attn_mask": np.zeros((4, 49, 49), np.float32),
          "norm.weight": rs.randn(8).astype(np.float32)}
    got = convert.inflate_swin2d_to_3d(sd)
    want = jti.inflate_swin2d_to_3d(sd)
    assert set(got) == set(want) == {"patch_embed.proj.weight", "norm.weight",
                                    "layers.0.blocks.0.attn.relative_position_bias_table",
                                    "layers.0.blocks.1.attn.relative_position_bias_table"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["patch_embed.proj.weight"].shape == (8, 3, 2, 4, 4)
    assert got["layers.0.blocks.0.attn.relative_position_bias_table"].shape == (15 * 169, 2)


# ---------------------------------------------------------------- train state

def _retrieval_run(tmp):
    cfg = model_cfg(tcfg)
    return tcfg.RunConfig(model=cfg, path_output=str(tmp),
                          train=tcfg.TrainConfig(lr=1e-3, size_batch=B, seed=5))


def _nce_steps(run, state_file=None, steps=4, resume_at=None):
    """``steps`` nce steps of a fresh tiny retrieval model on fixed
    batches; with ``resume_at`` the state is saved after that many steps
    and the rest run on a new model, optimizer and state restored from the
    file."""
    def fresh():
        tm = ttasks.VioletRetrieval(run.model, device="cpu", seed=2)
        opt = build_optimizer(tm, run.train, 10)
        return tm, create_train_state(tm, opt), make_supervised_train_step(tm, opt, "nce")

    rs = np.random.RandomState(6)
    batches = [{"img": torch.from_numpy(rs.randint(0, 256, (B, 2, 64, 64, 3)).astype(np.uint8)),
                "txt": torch.from_numpy(rs.randint(5, 200, (B, X)).astype(np.int32)),
                "mask": torch.ones(B, X, dtype=torch.int32)} for _ in range(steps)]
    tm, state, step = fresh()
    for i, batch in enumerate(batches):
        if i == resume_at:
            tckpt.save_train_state(state, state_file)
            tm, state, step = fresh()
            state = tckpt.load_train_state(state_file, state)
            assert state.step == resume_at
        state, _ = step(state, batch, 5)
    return tm, state


def test_resume_matches_an_uninterrupted_run(tmp_path):
    """Two steps, the train state saved, a new model restored from it, two
    more steps: the parameters and moments of four uninterrupted steps, bit
    for bit."""
    run = _retrieval_run(tmp_path)
    tm_a, state_a = _nce_steps(run)
    tm_b, state_b = _nce_steps(run, str(tmp_path / "restore.state"), resume_at=2)
    assert state_a.step == state_b.step == 4
    assert_sd_equal(tm_b.state_dict(), tm_a.state_dict())
    for k in ("mu", "nu"):
        assert_sd_equal(state_b.opt_state[k], state_a.opt_state[k])
    assert state_b.opt_state["count"] == state_a.opt_state["count"] == 4


def test_corrupt_primary_restores_from_backup(tmp_path):
    """The double-buffered write: the second save rotates the first to
    ``.backup``; a truncated primary restores from it; neither -> error."""
    run = _retrieval_run(tmp_path)
    path = str(tmp_path / "restore.state")
    tm, state = _nce_steps(run, steps=1)
    tckpt.save_train_state(state, path)
    first = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    state.step = 9
    tckpt.save_train_state(state, path, meta={"step": 9})
    assert os.path.exists(path + ".backup")
    with open(path, "r+b") as f:
        f.truncate(100)
    restored = tckpt.load_train_state(path, state)
    assert restored.step == 1
    assert_sd_equal(tm.state_dict(), first)
    os.remove(path + ".backup")
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(path, state)


def test_train_state_shape_mismatch_is_refused(tmp_path):
    run = _retrieval_run(tmp_path)
    path = str(tmp_path / "restore.state")
    _, state = _nce_steps(run, steps=1)
    tckpt.save_train_state(state, path)
    with open(path, "rb") as f:
        saved = tmsgpack.unpackb(f.read())
    name = next(iter(saved["params"]))
    saved["params"][name] = np.zeros((1,), np.float32)
    with open(path, "wb") as f:
        f.write(tmsgpack.packb(saved))
    with pytest.raises(FileNotFoundError):
        tckpt.load_train_state(path, state)

