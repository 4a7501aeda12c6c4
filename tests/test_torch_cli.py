"""The port's run loop and task CLIs on the CPU, against the JAX package
where the two can be held side by side.

Each CLI's ``main(argv, device="cpu", decode=...)`` runs on
``tests/synth_data.py`` layouts at ``TINY_RUN_OVERRIDES`` widths, frames
decoded by cv2 (the caller's decode function); the CLIs build their models
in bf16, as on the card, and run so here. The parity checks against JAX
build the port's models in fp32 through each CLI's own builder: the
retrieval eval on a JAX-written checkpoint, checkpoints crossing between the
packages' ``load_initial_params``, and the dVAE tokens of ``extract_vq``.
The agent's meters, best epoch and logging cadence are held to the JAX
agent's on the same loss sequences; the metrics log and the loop's profiler
window (``core/tracing.py``) write their files.
"""

import json
import os
import shutil
from collections import defaultdict

import cv2
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401  (pins JAX to the CPU)
from tests.torch_threads import torch_threads  # noqa: F401  (the cores' share under xdist)

import jax
import jax.numpy as jnp

from empirical_mvm_tpu.cli import common as jcommon
from empirical_mvm_tpu.cli import extract_vq as jvq
from empirical_mvm_tpu.core import config as jcfg
from empirical_mvm_tpu.models import pretrain as jpretrain
from empirical_mvm_tpu.models import tasks as jtasks
from empirical_mvm_tpu.parallel.mesh import make_mesh
from empirical_mvm_tpu.teachers import dvae as jdvae
from empirical_mvm_tpu.train import agent as jagent
from empirical_mvm_tpu.train import checkpoint as jckpt
from empirical_mvm_tpu.train import evaluators as jev
from empirical_mvm_tpu.train import metrics as jmetrics
from empirical_mvm_torch.cli import caption as tcaption
from empirical_mvm_torch.cli import common as tcommon
from empirical_mvm_torch.cli import convert_ckpt as tconvert
from empirical_mvm_torch.cli import extract_vq as tvq
from empirical_mvm_torch.cli import parity_eval as tparity
from empirical_mvm_torch.cli import pretrain as tpretrain_cli
from empirical_mvm_torch.cli import qa as tqa
from empirical_mvm_torch.cli import retrieval as tretrieval
from empirical_mvm_torch.cli import retrieval_eval as tretrieval_eval
from empirical_mvm_torch.core import config as tcfg
from empirical_mvm_torch.core import tracing as ttracing
from empirical_mvm_torch.data import datasets as tdata
from empirical_mvm_torch.data.loader import ShardedBatchLoader
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.teachers import dvae as tdvae
from empirical_mvm_torch.train import agent as tagent
from empirical_mvm_torch.train import checkpoint as tckpt
from empirical_mvm_torch.train import evaluators as tev
from empirical_mvm_torch.train import metrics as tmetrics
from tests import synth_data
from tests.test_torch_checkpoint import assert_sd_equal, fill, leaves
from tests.test_torch_retrieval import TinyRetrievalDataset, _capture_scores

DVAE_TINY = dict(n_hid=16, n_blk_per_group=1, vocab_size=64)
# a dVAE token that differs between the packages (cv2's resize against the
# port's, within one uint8 step) must be a near tie: its top-2 logit margin
# under this share of the logits' spread at that cell
VQ_MARGIN_SHARE = 0.05


def cv2_decode(data):
    a = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if a is None else a[:, :, ::-1]


def write_cfg(tmp, task_type, task, ds_name, extra=None):
    cfg = {"type": task_type, "task": task, "dataset": [ds_name],
           "data_dir": str(tmp / "data"), "path_output": str(tmp / "out"),
           "tokenizer": str(tmp / "vocab.txt"), "lr": 1e-3, "size_option": 3,
           **synth_data.TINY_RUN_OVERRIDES, **(extra or {})}
    path = tmp / f"{task}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    synth_data.write_vocab(str(tmp / "vocab.txt"))
    data = str(tmp / "data")
    synth_data.make_downstream(data, "msrvtt", "msrvtt-retrieval", kind="retrieval")
    synth_data.make_downstream(data, "msrvtt", "msrvtt-caption", kind="retrieval")
    synth_data.make_downstream(data, "tgif", "qamc-task", kind="qamc")
    synth_data.make_downstream(data, "tgif", "qaoe-task", kind="qaoe")
    synth_data.make_pretrain(data, "webvid2.5m")
    # the val split a copy of the train shards: the val eval then measures
    # the train-split loss, which must fall over the run
    with open(tmp / "data" / "txt_webvid2.5m.json") as f:
        txt = json.load(f)
    shutil.copy(tmp / "data" / "webvid2.5m_train_0.tsv", tmp / "data" / "webvid2.5m_val_0.tsv")
    txt["val"] = txt["train"]
    (tmp / "data" / "txt_webvid2.5m.json").write_text(json.dumps(txt))
    return tmp


def run_dir_files(result):
    return set(os.listdir(result["run_dir"]))


@pytest.fixture(scope="module")
def pretrained(env):
    cfg = write_cfg(env, "pretrain", "pretrain", "webvid2.5m",
                    {"size_part": 2, "mvm_target": ["pixel"], "pretrain_masks": ["rm", "bm"],
                     "size_epoch": 6})
    return tpretrain_cli.main(["--config", cfg], device="cpu", decode=cv2_decode)


def test_pretrain_cli_writes_the_jax_files_and_its_loss_falls(pretrained):
    """What the JAX pretrain CLI writes (args.json, the eval-step and final
    checkpoints, restore.state, log.json, metrics.jsonl), val losses at
    step 0 and later eval steps, and the train-split val loss falling over
    the run (the directional check of tests/test_e2e_cli.py)."""
    files = run_dir_files(pretrained)
    steps = pretrained["steps"]
    assert steps == 6 * pretrained["steps_per_epoch"] == 12
    assert {"args.json", "log.json", "metrics.jsonl", "restore.state",
            f"ckpt_violet_pretrain_final_{steps}.msgpack"} <= files
    with open(os.path.join(pretrained["run_dir"], "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    val = [r for r in recs if any(k.startswith("val_") for k in r)]
    at = sorted({r["step"] for r in val})
    assert at[0] == 0 and len(at) >= 2, at
    key = next(k for k in val[0] if k.endswith("/total"))
    vals = {r["step"]: r[key] for r in val}
    assert vals[at[-1]] < vals[at[0]], vals
    assert val[0][next(k for k in val[0] if k.endswith("/n_batches"))] >= 1


@pytest.mark.parametrize("cli,args,task,head,extra", [
    ("retrieval", [], "msrvtt-retrieval", "fc", {}),
    ("qa", ["--mode", "qamc-gen"], "qamc-task", "fc_mtm", {}),
    ("qa", ["--mode", "qaoe-mlm"], "qaoe-task", "fc_mtm", {}),
    ("qa", ["--mode", "qamc"], "qamc-task", "fc", {}),
    ("qa", ["--mode", "qamc-mlm"], "qamc-task", "fc_mtm", {}),
    ("qa", ["--mode", "qaoe"], "qaoe-task", "fc", {"size_vocab": 4}),
    ("qa", ["--mode", "qaoe-fib"], "qaoe-task", "fc_mtm", {"enable_prompt": True}),
    ("caption", [], "msrvtt-caption", "fc_mtm", {}),
])
def test_finetune_cli_writes_the_jax_files(env, pretrained, cli, args, task, head, extra):
    """Each fine-tune CLI from the port's pretrain checkpoint: every trunk
    leaf loaded, none kept at init; args.json, the epoch checkpoint (a flax
    tree the JAX ``load_params`` reads, with the head), log.json with the
    epoch's train losses and evals, metrics.jsonl."""
    kind, ds = {"msrvtt-retrieval": ("retrieval", "msrvtt"), "qamc-task": ("qamc", "tgif"),
                "qaoe-task": ("qaoe", "tgif"), "msrvtt-caption": ("caption", "msrvtt")}[task]
    cfg = write_cfg(env, kind, task, ds, extra)
    ckpt = os.path.join(pretrained["run_dir"],
                        f"ckpt_violet_pretrain_final_{pretrained['steps']}.msgpack")
    main = {"retrieval": tretrieval, "qa": tqa, "caption": tcaption}[cli].main
    res = main(args + ["--config", cfg, "--path_ckpt", ckpt], device="cpu", decode=cv2_decode)
    trunk = [p for p in res["load"]["loaded"] if p.split(".")[0] in ("enc_img", "enc_txt",
                                                                      "trsfr")]
    assert trunk and not [p for p in res["load"]["kept"]
                          if p.split(".")[0] in ("enc_img", "enc_txt", "trsfr")]
    files = run_dir_files(res)
    assert {"args.json", "log.json", "metrics.jsonl", f"ckpt_violet_{task}_1.msgpack"} <= files
    tree = jckpt.load_params(os.path.join(res["run_dir"], f"ckpt_violet_{task}_1.msgpack"))
    assert {"enc_img", "enc_txt", "trsfr", head} <= set(tree)
    with open(os.path.join(res["run_dir"], "log.json")) as f:
        log = json.load(f)
    assert len(log["ls_tr"]) == 1 and np.isfinite(log["ls_tr"][0]["total"])
    assert len(log["ac_vl"]) == 1
    with open(os.path.join(res["run_dir"], "args.json")) as f:
        assert json.load(f)["path_ckpt"] == ckpt


def test_caption_scores_in_range(env):
    cfg = write_cfg(env, "caption", "msrvtt-caption", "msrvtt", {"size_epoch": 0})
    res = tcaption.main(["--config", cfg], device="cpu", decode=cv2_decode)
    scores = res["scores"]["val"]
    assert set(scores) == {"bleu4", "cider", "rouge_l", "meteor"}
    assert all(0.0 <= v <= 100.0 for k, v in scores.items() if k != "cider")
    assert scores["cider"] >= 0.0


def test_retrieval_eval_and_parity_eval(env, tmp_path):
    """``retrieval_eval`` then ``parity_eval`` on its checkpoint with
    ``--expected`` at its R@1/5/10: exit 0; off by more than ``--tol``:
    exit 1."""
    cfg = write_cfg(env, "retrieval", "msrvtt-retrieval", "msrvtt", {"size_epoch": 0})
    res = tretrieval.main(["--config", cfg], device="cpu", decode=cv2_decode)
    ckpt = str(tmp_path / "ret.msgpack")
    model = tretrieval.build_model(tcfg.load_run_config(cfg), "cpu")
    tckpt.save_params(model, ckpt)
    m = tretrieval_eval.main(["--config", cfg, "--path_ckpt", ckpt], device="cpu",
                             decode=cv2_decode)
    assert m["load"]["loaded"] and not m["load"]["kept"] and res["steps"] == 0
    want = ",".join(str(m[k]) for k in ("r1", "r5", "r10"))
    out = tparity.main(["--config", cfg, "--path_ckpt", ckpt, "--expected", want,
                        "--tol", "0.01"], device="cpu", decode=cv2_decode)
    assert out["parity_ok"] and out["r1"] == m["r1"]
    off = ",".join(str(m[k] + 5.0) for k in ("r1", "r5", "r10"))
    with pytest.raises(SystemExit) as e:
        tparity.main(["--config", cfg, "--path_ckpt", ckpt, "--expected", off, "--tol",
                      "0.01"], device="cpu", decode=cv2_decode)
    assert e.value.code == 1


@pytest.mark.parametrize("cli", [tretrieval, tqa, tcaption, tpretrain_cli, tretrieval_eval,
                                 tparity, tvq])
def test_cli_without_a_card_or_a_decoder_raises(env, cli):
    """``device="cpu"`` without a decode function raises, and so does the
    default device where there is no card: no CPU decoder and no CPU device
    is picked for the caller."""
    argv = (["--tsv", "x", "--dvae", "x", "--out", "x"] if cli is tvq
            else ["--config", "x.json", "--path_ckpt", "x"] + (
                ["--mode", "qamc"] if cli is tqa else []))
    with pytest.raises(ValueError, match="decode function"):
        cli.main(argv, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            cli.main(argv)


# ------------------------------------------------- checkpoints across packages

def _jax_retrieval_setup(cfg_path):
    run = jcfg.load_run_config(cfg_path)
    jm = jtasks.VioletRetrieval(config=run.model)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)), jnp.zeros((1, 12), jnp.int32),
        jnp.ones((1, 12), jnp.int32)))["params"]
    return run, jm, fill(shapes, seed=7)


def test_jax_retrieval_loads_the_port_pretrain_checkpoint(env, pretrained):
    """The JAX retrieval CLI's ``load_initial_params`` over the port's
    pretrain checkpoint takes every trunk leaf and the score head from it."""
    import dataclasses
    ckpt = os.path.join(pretrained["run_dir"],
                        f"ckpt_violet_pretrain_final_{pretrained['steps']}.msgpack")
    cfg = write_cfg(env, "retrieval", "msrvtt-retrieval", "msrvtt")
    run, jm, init = _jax_retrieval_setup(cfg)
    run = dataclasses.replace(run, path_ckpt=ckpt)
    got = jcommon.load_initial_params(run, jm, lambda: init, heads={"fc": "score_head"})
    saved = leaves(tckpt.load_tree(ckpt))
    for k, v in leaves(got).items():
        assert k in saved, k
        np.testing.assert_array_equal(np.asarray(v), saved[k], err_msg=k)


def test_port_retrieval_loads_a_jax_pretrain_checkpoint(env, tmp_path):
    """The reverse: a JAX-written pretrain checkpoint through the port's
    ``load_initial_params`` into the retrieval model: every leaf loaded (the
    pretrain score head too), equal to the JAX tree's."""
    cfg_path = write_cfg(env, "pretrain", "pretrain", "webvid2.5m", {"mvm_target": ["pixel"]})
    run = jcfg.load_run_config(cfg_path)
    jm = jpretrain.VioletPretrain(config=run.model, mvm_target=("pixel",))
    args = (jnp.zeros((2, 2, 64, 64, 3), jnp.uint8), jnp.zeros((2, 12), jnp.int32),
            jnp.ones((2, 12), jnp.int32))
    keys = {k: jax.random.PRNGKey(0) for k in ("params", "dropout", "mask")}
    tree = fill(jax.eval_shape(lambda: jm.init(keys, *args, method=jm.losses))["params"], 8)
    ckpt = str(tmp_path / "jax_pretrain.msgpack")
    jckpt.save_params(tree, ckpt)
    trun = tcfg.load_run_config(write_cfg(env, "retrieval", "msrvtt-retrieval", "msrvtt",
                                          {"path_ckpt": ckpt}))
    model = tretrieval.build_model(trun, "cpu", torch.float32)
    report = tcommon.load_initial_params(trun, model)
    assert not report["kept"] and set(report["ignored"]) == {"fc_mtm", "decoder_pixel"}
    want = convert.state_dict_from_flax({k: v for k, v in tree.items()
                                         if k not in ("fc_mtm", "decoder_pixel")})
    assert_sd_equal(model.state_dict(), want)


def test_retrieval_eval_builder_matches_jax_on_a_jax_checkpoint(env, tmp_path, monkeypatch):
    """The retrieval eval's model builder in fp32, loaded from a JAX-written
    checkpoint, against the JAX ``retrieval_two_stage_eval`` on the JAX
    load of it: scores within the fp32 tolerance of
    tests/test_torch_retrieval.py, the same rank metrics."""
    import dataclasses
    cfg = write_cfg(env, "retrieval", "msrvtt-retrieval", "msrvtt")
    run, jm, tree = _jax_retrieval_setup(cfg)
    ckpt = str(tmp_path / "jax_ret.msgpack")
    jckpt.save_params(tree, ckpt)
    trun = dataclasses.replace(tcfg.load_run_config(cfg), path_ckpt=ckpt)
    model = tretrieval.build_model(trun, "cpu", torch.float32)
    assert not tcommon.load_initial_params(trun, model)["kept"]
    ds = TinyRetrievalDataset(x=12)
    j_seen = _capture_scores(monkeypatch, jev)
    t_seen = _capture_scores(monkeypatch, tev)
    ref = jev.retrieval_two_stage_eval(jm, jckpt.load_params(ckpt), ds, chunk_size=16,
                                       encode_batch=4, mesh=make_mesh(1))
    out = tev.retrieval_two_stage_eval(model, ds, chunk_size=16, encode_batch=4, device="cpu")
    (js,), (ts,) = j_seen, t_seen
    np.testing.assert_allclose(ts, js, atol=2e-4, rtol=0)
    for k in ("r1", "r5", "r10", "medr"):
        assert out[k] == ref[k], (k, out, ref)


def test_convert_ckpt_cli(env, tmp_path):
    """A trainer-wrapped reference ``.pt`` -> ``.msgpack`` with the score
    head: what the port's retrieval model loads, every leaf."""
    cfg = write_cfg(env, "retrieval", "msrvtt-retrieval", "msrvtt")
    run = tcfg.load_run_config(cfg)
    model = tretrieval.build_model(run, "cpu", torch.float32)
    src, dst = str(tmp_path / "ref.pt"), str(tmp_path / "ref.msgpack")
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, src)
    tconvert.main(["--src", src, "--dst", dst, "--config", cfg, "--heads", "fc=score_head"])
    assert_sd_equal(tckpt.load_params(dst), model.state_dict())
    jtree = jckpt.load_params(dst)
    assert {"enc_img", "enc_txt", "trsfr", "fc"} == set(jtree)


# ------------------------------------------------------------ data and tokens

def test_caption_dataset_items_do_not_depend_on_loader_threads(env):
    """The caption corruption and clip draw come from the item's own rng:
    the batches of 1 and 6 loader threads are identical."""
    run = tcfg.load_run_config(write_cfg(env, "caption", "msrvtt-caption", "msrvtt",
                                         {"size_batch": 2}))
    tokzr = load_tokenizer(run.data.tokenizer)
    img, txt = tcommon.tsv_sources(run)
    ds = tdata.CaptionDataset(run, "train", tokzr, img, txt["train"], mask_prob=0.5)
    got = []
    for threads in (1, 6):
        ld = ShardedBatchLoader(ds, 2, shuffle=True, seed=3, num_threads=threads)
        got.append(list(ld))
        ld.close()
    assert len(got[0]) == len(got[1]) == 3
    masked = 0
    for a, b in zip(*got):
        for k in ("txt", "mask", "mask_ans", "vid", "raw"):
            np.testing.assert_array_equal(a[k], b[k])
        assert [(p.frames, p.ops) for p in a["img"]] == [(p.frames, p.ops) for p in b["img"]]
        masked += int((a["mask_ans"] >= 0).sum())
        np.testing.assert_array_equal(a["txt"][a["mask_ans"] >= 0], tokzr.mask_token_id)
    assert masked > 0


def test_extract_vq_tokens_match_jax(env, tmp_path):
    """``extract_vq`` on a pretrain shard with a tiny fp32 dVAE written as a
    flax ``.msgpack``, against the JAX ``extract_tsv``: the same videos and
    grids; a token that differs (the two decoders' resizes differ by a
    uint8 step) is a near tie of the port's logits, within
    ``VQ_MARGIN_SHARE``."""
    shapes = jax.eval_shape(lambda: jdvae.DvaeEncoder(**DVAE_TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))["params"]
    rs = np.random.RandomState(9)
    tree = jax.tree.map(lambda s: (0.2 * rs.randn(*s.shape)).astype(np.float32), shapes)
    path = str(tmp_path / "dvae.msgpack")
    jckpt.save_params(tree, path)
    tsv = str(env / "data" / "webvid2.5m_train_0.tsv")
    kw = dict(size_img=64, size_patch=32, size_frame=2, batch=3)
    jteacher = jvq.load_dvae_teacher(path, dtype=jnp.float32, **DVAE_TINY)
    want = jvq.extract_tsv(tsv, jteacher, **kw)
    teacher = tvq.load_dvae_teacher(path, dtype=torch.float32, device="cpu", **DVAE_TINY)
    got = tvq.extract_tsv(tsv, teacher, device="cpu", decode=cv2_decode, **kw)
    assert list(got) == list(want) and len(got) == 4
    # the port's logits at every cell, on the port's own frames
    plans = [tvq._clip_plan(tvq.open_tsv(tsv)[r][1:], 16, 2) for r in range(4)]
    from empirical_mvm_torch.data.jpeg import HostDecoder
    from empirical_mvm_torch.data.loader import materialize
    img = materialize({"img": plans}, HostDecoder(cv2_decode), "cpu")["img"]
    with torch.no_grad():
        x = tdvae.map_pixels(tdvae.unnormalize_imagenet(img.reshape(-1, 16, 16, 3))
                             .clamp(0.0, 1.0))
        logits = teacher(x).reshape(4, 2, 2, 2, -1).numpy()
    differ = 0
    for i, vid in enumerate(got):
        g, w = np.stack(got[vid]), np.stack(want[vid])
        assert g.dtype == np.int32 and g.shape == w.shape == (2, 2, 2)
        for idx in zip(*np.nonzero(g != w)):
            cell = np.sort(logits[(i,) + idx])
            assert cell[-1] - cell[-2] < VQ_MARGIN_SHARE * (cell[-1] - cell[0]), (vid, idx)
            differ += 1
    assert differ <= 4, differ
    vq = {vid: got[vid] for vid in got}
    run = tcfg.load_run_config(write_cfg(env, "pretrain", "pretrain", "webvid2.5m",
                                         {"mvm_target": ["vq"], "size_frame": 2}))
    ds = tdata.PretrainTsvDataset(run, "train", load_tokenizer(run.data.tokenizer), tsv,
                                  {v: ["a cat"] for v in vq}, vq=vq)
    item = ds[0]
    assert not item["corrupt"] and (item["vq"] >= 0).sum() == 2 * 4


# ------------------------------------------------------------------ the agent

@pytest.mark.parametrize("seq", [[1.0, 2.0, float("nan"), 0.5], [float("inf")], []])
def test_running_meter_matches_jax(seq):
    t, j = tagent.RunningMeter(), jagent.RunningMeter()
    for v in seq:
        t.update(v)
        j.update(v)
    assert (np.isnan(t.val) and np.isnan(j.val)) or t.val == j.val


def test_best_epoch_matches_jax():
    log = {"ac_vl": [0.2, {"r1": 0.7}, 0.5], "ac_ts": [{"acc": 0.1}, 0.3, 0.3]}
    t, j = object.__new__(tagent.AgentBase), object.__new__(jagent.AgentBase)
    t.log, j.log = log, log
    assert t.best_epoch() == j.best_epoch() == ((1, 0.7), (1, 0.3))


LOSSES = [2.0, 1.5, float("nan"), 1.2, 1.1, 0.9, 1.0, 0.8, 0.7, 0.75, 0.6]


def _port_agent(tmp, logging_steps):
    a = object.__new__(tagent.AgentBase)
    a.cfg = tcfg.RunConfig(path_output=str(tmp), task="t",
                           train=tcfg.TrainConfig(logging_steps=logging_steps))
    a.meters, a.log = defaultdict(tagent.RunningMeter), defaultdict(list)
    a.metrics = tmetrics.MetricsLogger(str(tmp), "t")
    a.global_step, a._profiler, a.seed, a.state = 0, None, 0, None
    a.batches = lambda loader: (item for item in loader)
    return a


def _jax_agent(tmp, logging_steps):
    a = object.__new__(jagent.AgentBase)
    a.cfg = jcfg.RunConfig(path_output=str(tmp), task="t",
                           train=jcfg.TrainConfig(logging_steps=logging_steps))
    a.meters, a.log = defaultdict(jagent.RunningMeter), defaultdict(list)
    a.metrics = jmetrics.MetricsLogger(str(tmp), "t")
    a.global_step, a.state, a.rng, a.mesh = 0, None, None, None
    return a


def _records(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


@pytest.mark.parametrize("loop", ["train_epoch", "run_meta"])
def test_logging_cadence_matches_jax(tmp_path, monkeypatch, loop):
    """The same loss sequence through both agents' loops (every third step
    a logging step; a nan the meters skip): the same metrics.jsonl records
    and the same epoch means."""
    monkeypatch.setattr(jagent, "shard_batch", lambda mesh, b: b)
    tagents = {"train_epoch": tagent.AgentBase, "run_meta": tagent.PretrainAgent}
    jagents = {"train_epoch": jagent.AgentBase, "run_meta": jagent.PretrainAgent}
    t = _port_agent(tmp_path / "port", 3)
    t.__class__ = tagents[loop]
    j = _jax_agent(tmp_path / "jax", 3)
    j.__class__ = jagents[loop]
    tl, jl = iter(LOSSES), iter(LOSSES)
    t.train_step = lambda state, batch, seed: (state, {"total": torch.tensor(next(tl))})
    j.train_step = lambda state, batch, rng: (state, {"total": np.float32(next(jl))})
    if loop == "train_epoch":
        out_t = t.train_epoch([(None, {"x": torch.zeros(1)})] * len(LOSSES), 1)
        out_j = j.train_epoch([{"x": np.zeros(1, np.float32)}] * len(LOSSES), 1)
        for k in ("total",):
            assert out_t[k] == out_j[k]
    else:
        tasks = ["a", "b", "a", "a", "b", "b", "a", "b", "a", "b", "a"]
        t.run_meta(iter([(task, {"x": torch.zeros(1)}) for task in tasks]), len(LOSSES))
        j.run_meta(iter([(task, {"x": np.zeros(1, np.float32)}) for task in tasks]),
                   len(LOSSES))
        assert {k: m.val for k, m in t.meters.items()} == {k: m.val for k, m in j.meters.items()}
    t.metrics.close()
    j.metrics.close()
    assert _records(tmp_path / "port") == _records(tmp_path / "jax")
    assert len(_records(tmp_path / "port")) == len(LOSSES) // 3


def test_metrics_logger_and_profiler(tmp_path, monkeypatch, caplog):
    """The wandb gate warns where wandb does not import (as JAX's does); the
    run loop's profiler (``core/tracing.py``) writes its Chrome trace."""
    monkeypatch.setitem(__import__("sys").modules, "wandb", None)     # wandb fails to import
    log = tmetrics.MetricsLogger(str(tmp_path), "run", use_wandb=True)
    log.log({"a": 1}, 3)
    log.close()
    assert _records(tmp_path) == [{"step": 3, "a": 1.0}]
    assert any("wandb unavailable" in r.message for r in caplog.records)
    prof = ttracing.profiler("cpu")
    prof.start()
    torch.ones(4).sum()
    prof.stop()
    path = ttracing.write_trace(prof, str(tmp_path / "prof"))
    assert path == str(tmp_path / "prof" / "trace.json") and os.path.getsize(path) > 0


def test_profile_n_steps_window(tmp_path):
    """``train.profile_n_steps`` profiles steps [3, 3 + n) of the loop and
    writes the trace under ``profile/``; the config key loads as in JAX."""
    a = _port_agent(tmp_path, 100)
    a.cfg = tcfg.RunConfig(path_output=str(tmp_path), task="t",
                           train=tcfg.TrainConfig(logging_steps=100, profile_n_steps=2))
    a.device = torch.device("cpu")
    a.train_step = lambda state, batch, seed: (state, {"total": torch.ones(()) * 2})
    seen = []
    real = ttracing.profiler

    def spy(device):
        seen.append(a.global_step)
        return real(device)

    import empirical_mvm_torch.train.agent as agent_mod
    agent_mod.profiler, old = spy, agent_mod.profiler
    try:
        a.train_epoch([(None, {})] * 8, 1)
    finally:
        agent_mod.profiler = old
    assert seen == [3]
    assert os.path.exists(tmp_path / "profile" / "trace.json")
    assert tcfg.load_run_config({"profile_n_steps": 3}).train.profile_n_steps == \
        jcfg.load_run_config({"profile_n_steps": 3}).train.profile_n_steps == 3


def test_pad_batch_and_the_one_process_gather_match_jax():
    """Tail batches padded by repeating the last row, as the JAX
    ``pad_batch``; lists pass as they are; one process is the main one and
    its gather is the identity."""
    from empirical_mvm_tpu.parallel import mesh as jmesh
    from empirical_mvm_torch.parallel import mesh as tmesh
    rs = np.random.RandomState(0)
    batch = {"img": rs.rand(3, 2).astype(np.float32), "txt": rs.randint(0, 9, (3, 4)),
             "vid": ["a", "b", "c"]}
    want, n_j = jmesh.pad_batch(batch, 5)
    got, n_t = tmesh.pad_batch({k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                for k, v in batch.items()}, 5)
    assert n_t == n_j == 3 and got["vid"] == want["vid"]
    for k in ("img", "txt"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    same, n = tmesh.pad_batch(got, 5)
    assert same is got and n == 5
    assert tmesh.is_main_process() and tmesh.all_gather_metrics([0.5, 1.0]) == [0.5, 1.0]
