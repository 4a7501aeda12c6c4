"""The pretrain step fed by the port's loader, against the JAX package's on
the same batch, at tiny widths on the CPU (the captions tokenized over
``tests/synth_data.py``'s vocabulary): ``VioletPretrain(mvm_target=
("pixel", "hog"))`` carrying the JAX params through ``state_dict_from_flax``,
every dropout and drop-path rate at 0, the same masks and VTM negatives on
both sides (the JAX draws replaced as in ``test_torch_pretrain.py``).

The batches come from the port's ``ShardedBatchLoader`` and its device
stage on the CPU (cv2 decodes, as the JAX package decodes): a 2-frame
webvid batch and a 1-frame cc3m batch (``size_frame`` 1, the T = 1 Video
Swin), each holding a corrupt row (no frames) and a vid its captions lack.
Both models read the batch's ``corrupt`` flag: the clip zeroed after
normalization, and left out of the hog loss.
"""

import functools
import json
import os

import cv2
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.data import masking as jmask
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import violet as jviolet
from empirical_mvm_tpu.train import optimizer as jopt
from empirical_mvm_tpu.train import train_step as jts
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.data import datasets as tds
from empirical_mvm_torch.data import loader as tld
from empirical_mvm_torch.data import masking as tmask
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.models.pretrain import VioletPretrain, draw_negatives
from empirical_mvm_torch.train import optimizer as topt
from empirical_mvm_torch.train.train_step import create_train_state, make_pretrain_train_step
from tests import synth_data
from tests.test_torch_pretrain import BERT, GRAD_TOL, LOSS_TOL, SWIN, _np_tree

# synth_data's vocabulary: [PAD] 0, [CLS] 2, [SEP] 3, [MASK] 4
SPECIAL, MASK_ID = (2, 3, 0), 4
HEADS = {"fc": "score_head", "fc_mtm": "mlm_head", "decoder_pixel": "linear",
         "decoder_hog": "linear"}
TARGETS = ("pixel", "hog")
B = 4


def _model_cfg(c):
    return c.ModelConfig(size_img=64, size_frame=2, size_txt=8,
                         fusion=c.BertConfig(**BERT), text=c.BertConfig(**BERT),
                         swin_custom=c.SwinConfig(**SWIN))


def cv2_decode(data):
    a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if a is None else a[:, :, ::-1]


def _loader_batch(d, name, rows, vocab):
    """The first batch of a shard of ``rows`` through the port's loader."""
    run = tcfg.load_run_config({"size_img": 64, "size_frame": 2, "size_txt": 8,
                                "img_transform": ["img_rand_crop"]})
    with open(os.path.join(d, "txt.json")) as f:
        txt = json.load(f)
    path = os.path.join(d, f"{name}_train_0.tsv")
    with open(path, "w") as f:
        f.write("\n".join("\t".join(r) for r in rows) + "\n")
    ds = tds.PretrainTsvDataset(run, "train", load_tokenizer(vocab), path, txt, name)
    loader = tld.ShardedBatchLoader(ds, B, shuffle=True, seed=1, num_threads=2)
    meta = tld.MetaLoader({name: (loader, 1)}, seed=1)
    _, batch = next(iter(tld.DevicePrefetcher(meta, "cpu", cv2_decode)))
    meta.close()
    return batch


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("loader_step"))
    rs = np.random.RandomState(0)
    frames = [synth_data._jpeg_b64(rs) for _ in range(6)]
    vocab = synth_data.write_vocab(os.path.join(d, "vocab.txt"))
    with open(os.path.join(d, "txt.json"), "w") as f:
        json.dump({f"{n}{i}": [f"a red cat runs {i} in the park"] for n in ("v", "i")
                   for i in range(3)}, f)
    batches = {
        "webvid2.5m": _loader_batch(d, "webvid2.5m", [
            ["v0"] + frames[:3], ["v1"], ["v2"] + frames[2:5], ["nocap"] + frames[:2]], vocab),
        "cc3m": _loader_batch(d, "cc3m", [["i0", frames[0]], ["i1", frames[1]], ["i2"],
                                          ["nocap", frames[3]]], vocab),
    }
    gen = torch.Generator().manual_seed(3)
    draws, fake = {}, {}
    for name, b in batches.items():
        t = b["img"].shape[1]
        draws[name] = tmask.draw_masks(gen, b["txt"], t, 2, 2, special_token_ids=SPECIAL,
                                       mask_token_id=MASK_ID, p_mask=0.3,
                                       mask_types=("bm", "rm"))
        mb = tmask.apply_masking(draws[name], torch.zeros(B, t, 64, 64, 3), b["txt"],
                                 mask_token_id=MASK_ID)
        fake[t] = (mb.mvm_mask.numpy(), mb.cov.numpy(), mb.txt.numpy(), mb.ans_mtm.numpy())
    neg_idx = draw_negatives(gen, B, 3)

    def fake_apply_masking(key, img, txt, vq, **kw):
        pix, cov, new_txt, ans = fake[img.shape[1]]
        return jmask.MaskedBatch(img=img * (1.0 - jnp.asarray(pix)), txt=jnp.asarray(new_txt),
                                 ans_mtm=jnp.asarray(ans),
                                 ans_mvm=jnp.full((B, img.shape[1] * 5), -1, jnp.int32),
                                 mvm_mask=jnp.asarray(pix), cov=jnp.asarray(cov))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmask, "apply_masking", fake_apply_masking)
        mp.setattr(jax.lax, "top_k",
                   lambda x, k: (None, jnp.asarray(neg_idx.numpy(), jnp.int32)))
        mp.setattr(jpretrain, "ScoreHead", functools.partial(jviolet.ScoreHead, dropout=0.0))
        jm = jpretrain.VioletPretrain(config=_model_cfg(jcfg), mvm_target=TARGETS,
                                      pretrain_tasks=("mtm", "vtm", "mvm"),
                                      pretrain_masks=("bm", "rm"), special_token_ids=SPECIAL,
                                      mask_token_id=MASK_ID)
        b0 = batches["webvid2.5m"]
        key = jax.random.PRNGKey(0)
        params = jax.jit(lambda: jm.init(
            {"params": key, "dropout": key, "mask": key},
            *(jnp.asarray(b0[k].numpy()) for k in ("img", "txt", "mask")),
            method=jm.losses)["params"])()
        init = jax.tree.map(np.asarray, params)
        rs = np.random.RandomState(2)
        params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * rs.randn(*np.shape(p))
                              .astype(np.float32), params)
        tm = VioletPretrain(_model_cfg(tcfg), mvm_target=TARGETS, device="cpu", seed=1)
        tm.load_state_dict(convert.state_dict_from_flax(params, tm.config, HEADS))
        tm.fc[0].p = 0.0
        tm.mask_token_id, tm.special_token_ids = MASK_ID, SPECIAL
        yield dict(jm=jm, params=params, init=init, tm=tm, batches=batches, draws=draws,
                   neg_idx=neg_idx)


def test_loader_batches_hold_the_corrupt_rows(setup):
    for name, b in setup["batches"].items():
        t = 2 if name == "webvid2.5m" else 1
        assert b["img"].shape == (B, t, 64, 64, 3) and b["img"].dtype == torch.uint8
        assert b["txt"].shape == (B, 8) and b["vq"].shape == (B, t * 5)
        # the row with no frames and the vid its captions lack
        assert int(b["corrupt"].sum()) == 2
        assert (b["img"][b["corrupt"]] == 0).all() and (b["img"][~b["corrupt"]] > 0).any()
        assert (b["txt"][b["corrupt"]][:, 2:] == 0).all()      # the empty caption


def _jax_batch(b):
    return {k: jnp.asarray(b[k].numpy()) for k in ("img", "txt", "mask", "vq", "corrupt")}


@pytest.mark.parametrize("name", ["webvid2.5m", "cc3m"])
def test_loader_fed_losses_and_gradients_match_jax(setup, name):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    b = setup["batches"][name]
    jb = _jax_batch(b)

    def jloss(p):
        ls = jm.apply({"params": p}, jb["img"], jb["txt"], jb["mask"], vq=jb["vq"],
                      corrupt=jb["corrupt"], method=jm.losses, deterministic=True,
                      rngs={"mask": jax.random.PRNGKey(1)})
        return ls["total"], ls

    jgrads, jls = jax.jit(jax.grad(jloss, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    ls = tm.losses(b["img"], b["txt"], b["mask"], draws=setup["draws"][name],
                   neg_idx=setup["neg_idx"], vq=b["vq"], corrupt=b["corrupt"])
    ls["total"].backward()
    assert set(ls) == {"mtm", "vtm", "mvm_pixel", "mvm_hog", "total"} == set(jls)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)
    want = convert.state_dict_from_flax(_np_tree(jgrads), tm.config, HEADS)
    for n, p in tm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), err_msg=n, **GRAD_TOL)
    tm.zero_grad(set_to_none=True)
    # the flag matters: without it the corrupt rows' clips and hog count
    with torch.no_grad():
        other = tm.losses(b["img"], b["txt"], b["mask"], draws=setup["draws"][name],
                          neg_idx=setup["neg_idx"], vq=b["vq"])
    assert abs(other["mvm_hog"].item() - ls["mvm_hog"].item()) > 1e-4


def test_loader_fed_train_step_matches_make_pretrain_train_step(setup):
    """One step of each package's ``make_pretrain_train_step`` on the webvid
    batch, each reading ``batch["corrupt"]`` itself: the same losses."""
    import copy
    jm, params = setup["jm"], setup["params"]
    tm = copy.deepcopy(setup["tm"])
    b = setup["batches"]["webvid2.5m"]
    tx = jopt.build_optimizer(params, lr=1e-3, max_iter=10)
    jstep = jts.make_pretrain_train_step(jm, tx, mesh=None, donate=False)
    _, jls = jstep(jts.create_train_state(params, tx), _jax_batch(b), jax.random.PRNGKey(7))
    opt = topt.AdamW(tm, 1e-3, 10)
    step = make_pretrain_train_step(tm, opt)
    _, ls = step(create_train_state(tm, opt),
                 dict(b, draws=setup["draws"]["webvid2.5m"], neg_idx=setup["neg_idx"]), 7)
    for k in ls:
        np.testing.assert_allclose(ls[k].item(), float(jls[k]), err_msg=k, **LOSS_TOL)


def test_zero_biases_and_a_corrupt_row_blow_up_both_packages_gradients(setup):
    """At the JAX package's own init (every bias 0, every LayerNorm scale 1)
    a corrupt row's zeroed clip stays exactly 0 through the Video Swin, so
    each LayerNorm there sees zero variance and scales its backward by
    1 / sqrt(eps). Both packages compute that same gradient: huge in each,
    equal to each other. Without the flag the row's zero frames normalize to
    nonzero pixels and the gradients stay small. A fault of the reference,
    kept by the port (ROADMAP Queue 3)."""
    import copy
    jm, init = setup["jm"], setup["init"]
    tm = copy.deepcopy(setup["tm"])
    tm.load_state_dict(convert.state_dict_from_flax(init, tm.config, HEADS))
    b = setup["batches"]["webvid2.5m"]
    jb = _jax_batch(b)
    peaks = {}
    for flag in (True, False):
        corrupt = jb["corrupt"] if flag else None

        def jloss(p):
            return jm.apply({"params": p}, jb["img"], jb["txt"], jb["mask"], vq=jb["vq"],
                            corrupt=corrupt, method=jm.losses, deterministic=True,
                            rngs={"mask": jax.random.PRNGKey(1)})["total"]

        jgrads = jax.jit(jax.grad(jloss))(init)
        want = convert.state_dict_from_flax(_np_tree(jgrads), tm.config, HEADS)
        tm.zero_grad(set_to_none=True)
        tm.losses(b["img"], b["txt"], b["mask"], draws=setup["draws"]["webvid2.5m"],
                  neg_idx=setup["neg_idx"], vq=b["vq"],
                  corrupt=b["corrupt"] if flag else None)["total"].backward()
        got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in tm.named_parameters()}
        for n, g in got.items():      # the same gradient, held at its own scale
            scale = max(float(want[n].abs().max()), 1.0)
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GRAD_TOL["rtol"],
                                       atol=GRAD_TOL["atol"] * scale, err_msg=n)
        peaks[flag] = max(float(want[n].abs().max()) for n in got)
    assert peaks[True] > 1e20 and peaks[False] < 1e6, peaks
