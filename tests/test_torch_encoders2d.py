"""The port's ResNet-50 and MERLOT encoders against the JAX package on the
CPU, fp32, inputs from numpy with a seed: ``EncImgR50`` (concat and mean)
and ``EncImgMerlot`` outputs and every gradient, train-mode and eval-mode
BatchNorm, the running statistics' fold (and the JAX package's weight decay
of them), a pretrain step and a supervised ``nce`` step with
``r50_train_bn``, the weight converters both ways, the torchvision and HF
ViT importers on synthetic state dicts, and checkpoints of both models.

The encoders' weights are the port's, drawn with a seed (convolutions
N(0, 1/fan_in), norms' weights near 1, BatchNorm biases near ``BN_SHIFT``,
other biases and embeddings small), the running statistics those of a
train-mode pass over another seeded input, and are carried to JAX by
``models/convert``; ``jax.eval_shape`` of the JAX ``init`` holds the carried
tree's structure, so no JAX ``init`` compiles. The BatchNorm biases sit
at 3 so that few ReLU inputs lie near 0: one whose input lies within fp32
roundoff of 0 flips on one side only and moves the gradient of the channel
it feeds by a term of its sum, 2-30 % of a tensor's largest element at
biases near 0 (as much between the port in fp32 and in fp64 as between the
port and JAX).
The MERLOT encoder is cut to ``VIT_DEPTH`` blocks on both sides (the JAX
field ``vit_depth``) at the fusion's tiny width (32, 4 heads: the ViT's
attention takes row 11's plain version in the port, XLA in JAX). Its R50
trunk is ``EncImgR50``'s, whose gradients the R50 cases hold: the MERLOT
case holds its output and the gradients from ``proj`` on, and leaves the
trunk and the input out of the backward on both sides.

Tolerances: encoder outputs within ``OUT_TOL`` (fp32 through 53
convolutions and their BatchNorms; measured 8e-6); each gradient element
within rtol 1e-3 plus ``GRAD_SCALE`` times the case's largest gradient
element (measured 4e-7 of it): in train mode a BatchNorm bias whose output
reaches the next BatchNorm through an active ReLU and a convolution has a
gradient that is zero in exact arithmetic (the batch mean removes it), so
it holds roundoff at the scale of its neighbours' gradients, not its own;
batch statistics within ``STAT_REL`` of their tensor's largest value,
folded running statistics within ``FOLD_REL``.
"""

import copy

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp
import optax

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import encoders2d as jenc
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.models.torch_import import (resnet50_params_from_torch,
                                                   vit_encoder_params_from_hf)
from empirical_mvm_tpu.train import losses as jlosses
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.models import common, convert
from empirical_mvm_torch.models import encoders2d as tenc
from empirical_mvm_torch.models import tasks as ttasks
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.checkpoint import (load_params, load_train_state, save_params,
                                                  save_train_state)
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests.test_torch_pretrain import (HEADS, LOSS_TOL, _np_tree, _t, carried_slice,
                                       losses_and_grads)
from tests.test_torch_qa_heads import SCORE, _text, two_steps_match_jax
from tests.test_torch_qa_heads import jax_scorehead  # noqa: F401  (the module fixture)

BERT = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
VIT_DEPTH = 2
OUT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL, GRAD_SCALE = 1e-3, 1e-5
# batch statistics inherit the forward's fp32 difference between the
# packages (3e-5 of a tensor's largest value read at the last stage, 16
# values a channel); a fold weights them by 0.1
STAT_REL, FOLD_REL = 1e-4, 2e-5
BN_LEAVES = ("running_mean", "running_var")
R50_PRETRAIN = dict(vis_backbone="r50", temporal_fusion="concat", r50_train_bn=True)
BN_SHIFT = 3.0


def model_cfg(c, **kw):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8, fusion=c.BertConfig(**BERT),
                         text=c.BertConfig(**BERT), **kw)


def seeded_weights(module, seed):
    """Seeded values for every parameter: weights of rank >= 2 N(0,
    1/fan_in), norms' weights 1 + 0.1 N(0, 1), biases and embeddings 0.1
    N(0, 1); then running statistics from a train-mode pass of the R50 over
    another seeded batch (folded at momentum 1)."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            z = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
            if p.ndim >= 2 and not name.split(".")[-1].startswith("emb_"):
                p.copy_(z / (p[0].numel() ** 0.5))
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * z)
            elif ".bn" in name or ".downsample.1." in name:
                p.copy_(BN_SHIFT + 0.1 * z)
            else:
                p.copy_(0.1 * z)
    res = (module.enc_img if hasattr(module, "enc_img") else module).res
    with torch.no_grad():
        res(torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32)), use_batch_stats=True)
    common.fold_bn_stats(module, momentum=1.0)
    return module


def _enc_tree(sd):
    """An image encoder's state_dict (no prefix) as its flax tree."""
    return convert._inverse(sd, convert._enc_img, "", "")


ENCODERS = {
    # name: (kind, fusion, train_bn, training pass)
    "r50_concat_train_bn": ("r50", "concat", True, True),
    "r50_mean_eval_bn": ("r50", "mean", True, False),
    "merlot_frozen_stats": ("merlot", "concat", False, True),
}


def build_encoder(name, seed=0):
    """The port encoder (seeded weights) and the JAX one with the carried
    tree, its structure held against ``jax.eval_shape`` of the JAX init."""
    kind, fusion, train_bn, _ = ENCODERS[name]
    if kind == "r50":
        tm = tenc.EncImgR50(model_cfg(tcfg), fusion, train_bn)
        jm = jenc.EncImgR50(model_cfg(jcfg), fusion=fusion, train_bn=train_bn)
    else:
        tm = tenc.EncImgMerlot(model_cfg(tcfg), train_bn, VIT_DEPTH)
        jm = jenc.EncImgMerlot(model_cfg(jcfg), vit_depth=VIT_DEPTH, train_bn=train_bn)
    seeded_weights(tm, seed)
    tree = _enc_tree(tm.state_dict())
    img = jnp.zeros((2, 2, 64, 64, 3))
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img))["params"]
    assert jax.tree.map(lambda s: tuple(s.shape), want) == jax.tree.map(np.shape, tree)
    return tm, jm, tree


def assert_grads_match(got, want):
    """Each port gradient (None where the parameter gets none: the unused
    ``emb_odr``, whose JAX gradient must then be 0) against JAX's, each
    element within ``GRAD_RTOL`` of it plus ``GRAD_SCALE`` of the largest
    gradient element of all. The stem's convolution and BatchNorm read at
    most 4.6e-7 of it here (their own largest elements are 0.4-8 % of it),
    with one torch thread or eight."""
    scale = max(want[n].abs().max().item() for n in got)
    for n, g in got.items():
        if g is None:
            assert n.endswith("emb_odr") and not want[n].any(), n
            continue
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * scale, err_msg=n)


def assert_stats_close(got, want, rel, what):
    """Each element within ``rel`` of the tensor's largest value."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=what)


def _stats_of(tree):
    """The ``mean`` / ``var`` leaves of a flax tree in its nesting: the
    layout of JAX's ``bn_stats``."""
    out = {k: _stats_of(v) if isinstance(v, dict) else v for k, v in tree.items()
           if isinstance(v, dict) or k in ("mean", "var")}
    return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}


def _stat_names(stats):
    """JAX ``bn_stats`` (``res.layer1_0.down_bn.mean``: a one-tuple) by the
    port's buffer names (``res.layer1.0.downsample.1.running_mean``)."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(stats):
        keys = [k.key for k in path if hasattr(k, "key")]
        name = topt.port_path(".".join(keys[:-1])).replace("down_bn", "downsample.1")
        out[f"{name}.running_{keys[-1]}"] = torch.from_numpy(np.asarray(v))
    return out


def run_both(name, seed=0):
    """Both encoders on one seeded clip batch: outputs, the gradient of a
    seeded weighting of the output with respect to every parameter and the
    input (JAX's in port names), and JAX's train-mode ``bn_stats``. The
    MERLOT case differentiates neither its trunk nor the input (JAX's
    gradients of them are 0, the port's None)."""
    tm, jm, tree = build_encoder(name, seed)
    kind, fusion, _, train = ENCODERS[name]
    trunk = kind == "r50"
    rs = np.random.RandomState(seed + 1)
    img = rs.randn(2, 2, 64, 64, 3).astype(np.float32)
    w = rs.randn(2, 5 if fusion == "mean" else 10, 32).astype(np.float32)

    def f(p, x):
        if not trunk:
            p, x = dict(p, res=jax.lax.stop_gradient(p["res"])), jax.lax.stop_gradient(x)
        (out, _), mut = jm.apply({"params": p}, x, deterministic=not train,
                                 mutable=["bn_stats"])
        return (out * w).sum(), (out, mut.get("bn_stats", {}))

    (gp, gx), (out, stats) = jax.jit(jax.grad(f, argnums=(0, 1), has_aux=True))(
        tree, jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(trunk)
    tm.res.requires_grad_(trunk)
    got, mask = tm(x, torch.Generator().manual_seed(0) if train else None)
    (got * torch.from_numpy(w)).sum().backward()
    return dict(tm=tm, tree=tree, got=got.detach(), mask=mask, want=np.asarray(out),
                got_gx=x.grad, want_gx=np.asarray(gx), jax_grads=gp,
                want_g=convert.enc_img_state_dict(_np_tree(gp), prefix=""), jax_stats=stats)


@pytest.fixture(scope="module")
def runs():
    return {name: run_both(name) for name in ENCODERS}


@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_outputs_and_gradients_match_jax(runs, name):
    """R50 with train-mode BatchNorm (batch statistics) and concat fusion,
    R50 on a deterministic pass (running statistics) with mean fusion, and
    MERLOT with frozen statistics on a training pass: the output tokens,
    the gradient of every parameter and of the input (MERLOT's from
    ``proj`` on). JAX differentiates its running statistics too (they are
    its parameters): on the passes that read them their gradients are not
    zero, while the port's buffers take none."""
    r = runs[name]
    kind, fusion, train_bn, train = ENCODERS[name]
    b, frames = 2, (1 if fusion == "mean" else 2)
    assert r["got"].shape == (b, frames * 5, 32) and torch.equal(
        r["mask"], torch.ones(b, frames * 5, dtype=torch.int32))
    np.testing.assert_allclose(r["got"].numpy(), r["want"], **OUT_TOL)
    params = dict(r["tm"].named_parameters())
    stats = {k for k in r["want_g"] if k.endswith(BN_LEAVES)}
    assert len(stats) == 2 * 53 and set(params) | stats == set(r["want_g"])
    if kind == "merlot":
        held = {n for n in r["want_g"] if n.startswith("res.")}
        assert len(held) == 53 * 5 and r["got_gx"] is None and not r["want_gx"].any()
        assert all(params[n].grad is None for n in held - stats)
        assert not any(r["want_g"][n].any() for n in held)
        params = {n: p for n, p in params.items() if n not in held}
    else:
        np.testing.assert_allclose(r["got_gx"].numpy(), r["want_gx"], rtol=GRAD_RTOL,
                                   atol=GRAD_SCALE * np.abs(r["want_gx"]).max())
        assert any(r["want_g"][k].any() for k in stats) != (train_bn and train)
    assert_grads_match({n: p.grad for n, p in params.items()}, r["want_g"])


def test_train_mode_batch_statistics_and_their_fold_match_jax(runs):
    """Each train-mode BatchNorm's batch mean and unbiased variance against
    JAX's ``bn_stats``, then ``fold_bn_stats`` (momentum 0.1) against the
    JAX one on the carried tree; a deterministic pass leaves nothing to
    fold."""
    r = runs["r50_concat_train_bn"]
    tm = copy.deepcopy(r["tm"])
    bns = {n: m for n, m in tm.named_modules() if isinstance(m, common.BatchNorm2d)}
    assert len(bns) == 53 and all(m.batch_stats is not None for m in bns.values())
    want_stats = _stat_names(r["jax_stats"])
    for n, m in bns.items():
        for leaf, stat in zip(BN_LEAVES, m.batch_stats):
            assert_stats_close(stat, want_stats[f"{n}.{leaf}"], STAT_REL, n)
    common.fold_bn_stats(tm)
    assert all(m.batch_stats is None for m in bns.values())
    folded = convert.enc_img_state_dict(_np_tree(jenc.fold_bn_stats(r["tree"], r["jax_stats"])),
                                        prefix="")
    for k, v in common.bn_buffers(tm).items():
        assert_stats_close(v, folded[k], FOLD_REL, k)
    assert all(m.batch_stats is None for m in runs["r50_mean_eval_bn"]["tm"].modules()
               if isinstance(m, common.BatchNorm2d))


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_weight_decay_reaches_the_running_statistics_in_jax_only(runs, weight_decay):
    """One AdamW update (lr 1e-2, no warmup, no clip) with the train-mode
    pass's gradients, then the fold. The port's running statistics follow
    torch's rule, 0.9 running + 0.1 batch, whatever the decay: they are
    buffers. The JAX package keeps them among its parameters, labelled
    ``other_decay`` by ``default_group_fn``; their gradient is 0 in train
    mode, so at weight decay 0 its fold equals the port's, and above 0
    AdamW first shrinks them by lr * weight_decay (a fault of the JAX
    package, ROADMAP Queue 3: ``tests/test_encoders2d.py`` uses lr 0)."""
    r, lr = runs["r50_concat_train_bn"], 1e-2
    tm = copy.deepcopy(r["tm"])
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: jopt.default_group_fn(tuple(k.key for k in path)), r["tree"])
    assert labels["res"]["bn1"] == {"scale": "other_nodecay", "bias": "other_nodecay",
                                    "mean": "other_decay", "var": "other_decay"}
    # the update of the statistics' leaves alone: their groups are those of
    # the whole tree (the labels go by the leaf's path), and a few shapes
    # compile fewer of JAX's per-op programs than the whole R50's
    stats, grads = ({"res": _stats_of(t["res"])} for t in (r["tree"], r["jax_grads"]))
    tx = jopt.build_optimizer(stats, lr=lr, max_iter=10, weight_decay=weight_decay,
                              warmup_ratio=0.0, max_grad_norm=0.0)
    updates, _ = tx.update(grads, tx.init(stats), stats)
    want = _stat_names(jenc.fold_bn_stats(optax.apply_updates(stats, updates), r["jax_stats"]))
    before = {k: v.clone() for k, v in common.bn_buffers(tm).items()}
    batch = {f"{n}.{leaf}": stat for n, m in tm.named_modules()
             if isinstance(m, common.BatchNorm2d) for leaf, stat in zip(BN_LEAVES, m.batch_stats)}
    opt = topt.AdamW(tm, lr, 10, weight_decay=weight_decay, warmup_ratio=0.0, max_grad_norm=0.0)
    params = dict(tm.named_parameters())
    assert all(opt.labels[n] == "other_nodecay" for n in params if ".bn" in n)
    opt.update(params, {n: p.grad for n, p in params.items()}, opt.init(params))
    common.fold_bn_stats(tm)
    for k, v in common.bn_buffers(tm).items():
        torch.testing.assert_close(v, 0.9 * before[k] + 0.1 * batch[k], atol=1e-6, rtol=1e-6)
        shrunk = 0.9 * before[k] * (1.0 - lr * weight_decay) + 0.1 * batch[k]
        assert_stats_close(want[k], shrunk, FOLD_REL, k)
    gap = max((want[k] - v).abs().max().item() for k, v in common.bn_buffers(tm).items())
    assert gap < 1e-4 if weight_decay == 0 else gap > 1e-3, gap


def synthetic_torchvision_r50(seed=0):
    """A torchvision ``resnet50().state_dict()`` in its names and shapes,
    seeded values (``fc`` and ``num_batches_tracked`` included)."""
    rs = np.random.RandomState(seed)
    sd = {k: rs.randn(*v.shape).astype(np.float32)
          for k, v in tenc.ResNet50().state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k] = np.abs(sd[k]) + 0.5
        sd[k.replace("running_var", "num_batches_tracked")] = np.array(7, np.int64)
    sd["fc.weight"], sd["fc.bias"] = rs.randn(1000, 2048).astype(np.float32), np.zeros(1000)
    return sd


def synthetic_hf_vit(layers, d, seed=0):
    """A HF ``ViTModel.encoder`` state_dict: separate query / key / value."""
    rs = np.random.RandomState(seed)
    sd = {}
    for i in range(layers):
        for name, shape in (("attention.attention.query", (d, d)),
                            ("attention.attention.key", (d, d)),
                            ("attention.attention.value", (d, d)),
                            ("attention.output.dense", (d, d)),
                            ("intermediate.dense", (4 * d, d)), ("output.dense", (d, 4 * d)),
                            ("layernorm_before", (d,)), ("layernorm_after", (d,))):
            sd[f"layer.{i}.{name}.weight"] = rs.randn(*shape).astype(np.float32)
            sd[f"layer.{i}.{name}.bias"] = rs.randn(shape[0]).astype(np.float32)
    return sd


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_torchvision_and_hf_vit_importers_match_jax():
    """``resnet50_state_dict_from_torchvision`` (torchvision names with
    ``fc`` and ``num_batches_tracked`` left out) and
    ``vit_state_dict_from_hf`` (query, key and value fused) load into the
    port's modules strictly, and their trees are the JAX
    ``resnet50_params_from_torch`` / ``vit_encoder_params_from_hf`` trees,
    leaf for leaf."""
    tv = synthetic_torchvision_r50()
    sd = convert.resnet50_state_dict_from_torchvision(tv, prefix="")
    tenc.ResNet50().load_state_dict(sd)
    assert not any("num_batches_tracked" in k or k.startswith("fc.") for k in sd)
    got = _leaves(convert._inverse(sd, convert._resnet50, "", ""))
    want = _leaves(resnet50_params_from_torch(tv))
    assert set(got) == set(want) and len(got) == 53 + 53 * 4
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    hf = synthetic_hf_vit(VIT_DEPTH, 32)
    merlot = tenc.EncImgMerlot(model_cfg(tcfg), vit_depth=VIT_DEPTH)
    vit = convert.vit_state_dict_from_hf(hf, VIT_DEPTH, prefix="vit.")
    missing, unexpected = merlot.load_state_dict(vit, strict=False)
    assert not unexpected and not any(k.startswith("vit.") for k in missing)
    got = _leaves(convert._inverse(vit, convert._vit_blocks, "", ""))
    want = _leaves(vit_encoder_params_from_hf(hf, "", VIT_DEPTH))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("backbone", ["r50", "merlot"])
def test_weight_carry_round_trip_and_checkpoints(backbone, tmp_path):
    """A pretrain model on each backbone: ``flax_from_state_dict`` gives the
    tree of the JAX model's ``init`` (``jax.eval_shape``), and
    ``state_dict_from_flax`` takes it back leaf for leaf, the running
    statistics as BatchNorm ``mean`` / ``var``; ``save_params`` ->
    ``load_params`` is bit-equal, and the train state keeps the running
    statistics too."""
    kw = dict(vis_backbone=backbone, temporal_fusion="concat", r50_train_bn=True)
    tm = seeded_weights(VioletPretrain(model_cfg(tcfg, **kw), device="cpu", seed=1), 3)
    sd = tm.state_dict()
    tree = convert.flax_from_state_dict(sd, tm.config)
    jm = jpretrain.VioletPretrain(config=model_cfg(jcfg, **kw), mvm_target=("pixel",))
    args = (jnp.zeros((2, 2, 64, 64, 3)), jnp.zeros((2, 8), jnp.int32),
            jnp.ones((2, 8), jnp.int32))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key, "mask": key}, *args,
                                            method=jm.losses))["params"]
    assert jax.tree.map(lambda a: tuple(a.shape), shapes) == jax.tree.map(np.shape, tree)
    assert tree["enc_img"]["res"]["layer1_0"]["down_bn"]["var"].shape == (256,)
    back = convert.state_dict_from_flax(tree, tm.config)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    path = str(tmp_path / "m.msgpack")
    save_params(tm, path)
    loaded = load_params(path)
    assert set(loaded) == set(sd) and all(torch.equal(loaded[k], v) for k, v in sd.items())
    opt = topt.AdamW(tm, 1e-3, 10)
    state = create_train_state(tm, opt)
    assert set(state.buffers) == set(common.bn_buffers(tm)) and len(state.buffers) == 2 * 53
    save_train_state(state, str(tmp_path / "s.state"))
    fresh = VioletPretrain(model_cfg(tcfg, **kw), device="cpu", seed=2)
    back = load_train_state(str(tmp_path / "s.state"),
                            create_train_state(fresh, topt.AdamW(fresh, 1e-3, 10)))
    assert all(torch.equal(back.buffers[k], v) for k, v in state.buffers.items())
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in sd.items())


def _r50_pretrain_cfg(c):
    return model_cfg(c, **R50_PRETRAIN)


def _r50_drawn(shapes):
    """The R50 pretrain tree from the port's ``seeded_weights`` (no JAX
    ``init`` compiles), its structure held against ``shapes``."""
    tm = seeded_weights(VioletPretrain(_r50_pretrain_cfg(tcfg), device="cpu", seed=1), 3)
    tree = jax.tree.map(np.array, convert.flax_from_state_dict(tm.state_dict(), tm.config,
                                                               HEADS))
    assert jax.tree.map(lambda a: tuple(a.shape), shapes) == jax.tree.map(np.shape, tree)
    return tree


@pytest.fixture(scope="module")
def r50_slice():
    """``test_torch_pretrain.py``'s carried slice on the R50 backbone with
    train-mode BatchNorm, its weights ``seeded_weights``' (BatchNorm biases
    at ``BN_SHIFT``)."""
    yield from carried_slice(_r50_pretrain_cfg, drawn=_r50_drawn)


def test_r50_pretrain_step_matches_jax_with_train_mode_batch_norm(r50_slice):
    """The losses and every gradient of the training pass (batch statistics
    in every BatchNorm) against JAX's; then one ``make_pretrain_train_step``
    at weight decay 0: its losses are the pass's, and the running
    statistics it folds after the update are JAX's ``fold_bn_stats`` of the
    same pass's ``bn_stats`` (whose Adam update is 0 at weight decay 0, the
    statistics' gradient being 0 in train mode), within ``FOLD_REL``. The
    update itself is the AdamW that every pretrain slice's two steps hold
    against the JAX step."""
    ls, jls, got, want, no_grad = losses_and_grads(r50_slice, train=True)
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    assert no_grad == {"enc_img.embeds.emb_odr"}
    assert_grads_match({n: None if n in no_grad else g for n, g in got.items()}, want)
    tm = copy.deepcopy(r50_slice["tm"])
    start = {k: v.clone() for k, v in common.bn_buffers(tm).items()}
    opt = topt.AdamW(tm, 1e-3, 10, weight_decay=0.0)
    step = make_pretrain_train_step(tm, opt)
    batch = dict(_t(r50_slice["batch"]), draws=r50_slice["draws"],
                 neg_idx=r50_slice["neg_idx"])
    state, ls1 = step(create_train_state(tm, opt), batch, 7)
    for k in ls:
        np.testing.assert_allclose(ls1[k].item(), ls[k].item(), err_msg=k, rtol=1e-6)
    folded = convert.state_dict_from_flax(
        _np_tree(jenc.fold_bn_stats(r50_slice["params"], r50_slice["jax_bn_stats"])),
        tm.config, HEADS)
    assert set(state.buffers) == set(start) and len(start) == 2 * 53
    for k, v in state.buffers.items():
        assert not torch.equal(v, start[k]), k
        assert_stats_close(v, folded[k], FOLD_REL, k)


def test_r50_nce_step_matches_the_jax_agent_step(jax_scorehead):
    """Two ``nce`` steps of a retrieval model on the R50 backbone (concat
    fusion, ``r50_train_bn``; 3 clips of one frame) against the JAX
    ``RetrievalAgent`` step's
    pieces with its ``bn_stats`` fold, at weight decay 0: losses and
    parameters as ``test_torch_qa_heads.py`` holds them, but 3e-4 of the
    resolved elements may exceed 2e-6 (the R50's 23.5 M elements resolve
    their gradients to about 1 %, not 0.1 %: 1.3e-4 of them read up to
    2.4e-5), step-0 gradients as ``assert_grads_match``, and the running
    statistics within ``FOLD_REL``."""
    tm = seeded_weights(VioletRetrieval(model_cfg(tcfg, **R50_PRETRAIN), device="cpu",
                                        seed=2), 4)
    tm.fc[0].p = 0.0
    jm = jtasks.VioletRetrieval(config=model_cfg(jcfg, **R50_PRETRAIN))
    # copies: the tree's arrays are views of the model's tensors, which the
    # port's steps update in place while JAX may still read them
    params = jax.tree.map(np.array, convert.flax_from_state_dict(tm.state_dict(), tm.config,
                                                                 SCORE))
    rs = np.random.RandomState(0)
    txt, mask = _text(rs, 3)
    batch = {"img": rs.randn(3, 1, 64, 64, 3).astype(np.float32), "txt": txt, "mask": mask}
    start = {k: v.clone() for k, v in common.bn_buffers(tm).items()}
    out = {}
    no_grad = two_steps_match_jax(jm, params, tm, batch, "nce",
                                  lambda o, b: jlosses.norm_softmax_loss(o, 0.05), SCORE,
                                  decay=0.0, out=out, grads_match=assert_grads_match,
                                  outliers=3e-4)
    assert no_grad == {"enc_img.embeds.emb_odr"}
    want = convert.state_dict_from_flax(_np_tree(out["jax_params"]), tm.config, SCORE)
    for k, v in common.bn_buffers(tm).items():
        assert not torch.equal(v, start[k]), k
        assert_stats_close(v, want[k], FOLD_REL, k)


def test_heads_read_the_first_text_token_under_mean_fusion():
    """Under mean temporal fusion the video tokens are one averaged frame's
    (1 + h * w). The port's heads read the first text token after them
    (``models/tasks.first_text``); the JAX ``_cls_pos`` counts the clip's T
    frames and reads T (1 + h * w), a text token further on or, at the
    msrvtt-retrieval shapes (5 frames of 7 x 7, 25 text tokens: index 250
    of 75), past the end, which JAX clamps to the last token (a fault of the
    JAX package, ROADMAP Queue 3). Under concat fusion the two agree."""
    for fusion, frames in (("mean", 1), ("concat", 2)):
        enc = tenc.EncImgR50(model_cfg(tcfg), fusion)
        with torch.no_grad():
            fi, _ = enc(torch.zeros(1, 2, 64, 64, 3))
        assert ttasks.first_text(fi) == frames * 5
        assert jtasks._cls_pos((1, 2, 64, 64, 3), 32) == 10
    assert jtasks._cls_pos((1, 5, 224, 224, 3), 32) == 250
