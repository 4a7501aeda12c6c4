"""Shared CLI wiring (counterpart of ``empirical_mvm_tpu/cli/common.py``;
ref: main_retrieval_tsv.py:67-103 and siblings): the config and its
command-line overrides, the run directory and its logging, the tokenizer
and data sources, and the lenient checkpoint load.

Every CLI's ``main(argv=None, *, device="cuda", decode=None)`` runs on the
card; a caller that asks for the CPU passes the frame decode function too
(:func:`run_device`). The models are built in bf16 (:data:`DTYPE`), as the
JAX CLIs build theirs.

Across cards, one process a card:
``python -m torch.distributed.run --nproc_per_node=N -m empirical_mvm_torch.cli.pretrain
--config configs/pretrain.json``. :func:`setup_run` joins the process group
(NCCL, ``cuda:LOCAL_RANK``), which is left at exit, and :func:`make_loaders`
gives each rank its ``size_batch / N`` rows of every global batch.
"""

from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import logging
import os
from datetime import datetime
from typing import Any, Mapping

import numpy as np
import torch

from empirical_mvm_torch.core.config import RunConfig, load_run_config
from empirical_mvm_torch.data.datasets import TsvImageSource, load_txt_json
from empirical_mvm_torch.data.loader import ShardedBatchLoader
from empirical_mvm_torch.data.tokenizer import load_tokenizer
from empirical_mvm_torch.models import convert
from empirical_mvm_torch.parallel.mesh import (all_gather_objects, destroy, distributed_init,
                                               is_main_process, per_rank_batch, process_count,
                                               process_index, rank_device)
from empirical_mvm_torch.train.checkpoint import (TORCH_SUFFIXES, load_torch_violet_ckpt,
                                                  load_tree)

logger = logging.getLogger("empirical_mvm_torch")

DTYPE = torch.bfloat16      # the JAX CLIs' dtype=jnp.bfloat16


def run_device(device, decode) -> torch.device:
    """The CLI's device: the card (this rank's, ``cuda:LOCAL_RANK``, under
    ``torch.distributed.run``), or the CPU with the caller's decode
    function. Neither a missing card nor a missing decoder is replaced."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this CLI runs on a CUDA card and torch.cuda.is_available() is "
                           "false; a caller that wants the CPU passes device='cpu' and a "
                           "decode function")
    if device.type == "cpu" and decode is None:
        raise ValueError("device='cpu' needs a decode function from the caller (bytes -> RGB "
                         "uint8 array, for example over cv2.imdecode); the CLIs pick no CPU "
                         "decoder themselves")
    return rank_device(device)


def parse_cli(description: str, argv=None) -> RunConfig:
    """(ref: utils/args.py:235-246 get_args)"""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--config", required=True, help="task JSON config")
    ap.add_argument("--path_output", default=None)
    ap.add_argument("--path_ckpt", default=None)
    ap.add_argument("--size_epoch", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = load_run_config(args.config)
    if args.path_output:
        cfg = dataclasses.replace(cfg, path_output=args.path_output)
    if args.path_ckpt is not None:
        cfg = dataclasses.replace(cfg, path_ckpt=args.path_ckpt)
    if args.size_epoch is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, size_epoch=args.size_epoch))
    return adopt_ckpt_args(cfg)


# architecture keys re-adopted from the checkpoint's run dir so eval uses the
# training-time model shape (ref: utils/args.py:248-277 update_args)
_ADOPT_KEYS = ("vis_backbone", "vis_backbone_size", "temporal_fusion",
               "txt_backbone_embed_only", "max_size_frame", "max_size_patch")


def adopt_ckpt_args(cfg: RunConfig) -> RunConfig:
    """The ``_ADOPT_KEYS`` of the ``args.json`` beside ``path_ckpt`` (either
    package's nested form, or the reference's flat one)."""
    if not cfg.path_ckpt:
        return cfg
    args_json = os.path.join(os.path.dirname(cfg.path_ckpt), "args.json")
    if not os.path.exists(args_json):
        return cfg
    with open(args_json) as f:
        trained = json.load(f)
    model_args = trained.get("model", trained)
    overrides = {k: model_args[k] for k in _ADOPT_KEYS if k in model_args}
    if overrides:
        logger.info("adopting model args from %s: %s", args_json, overrides)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **overrides))
    return cfg


def setup_run(cfg: RunConfig, device="cuda") -> RunConfig:
    """The process group of ``torch.distributed.run``, if this process was
    started by it (left at exit; JAX ``distributed_init``), then the run dir
    ``{path_output}/_{task}_{stamp}`` (a second run in the same second gets
    ``_{n}`` after it; rank 0's name is every rank's), logging to the
    console and its ``stdout.txt``, and ``args.json`` (ref: main_*.py
    path_output stamping)."""
    if distributed_init(device) is not None:
        atexit.register(destroy)
    stamp = datetime.now().strftime("%Y%m%d%H%M%S")
    out = os.path.join(cfg.path_output, f"_{cfg.task}_{stamp}")
    n = 1
    while os.path.exists(out):
        n += 1
        out = os.path.join(cfg.path_output, f"_{cfg.task}_{stamp}_{n}")
    out = all_ranks_take(out)
    cfg = dataclasses.replace(cfg, path_output=out)
    if is_main_process():
        os.makedirs(out, exist_ok=True)
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(levelname)s %(message)s",
                            handlers=[logging.StreamHandler(),
                                      logging.FileHandler(os.path.join(out, "stdout.txt"))],
                            force=True)
        with open(os.path.join(out, "args.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    else:
        logging.basicConfig(level=logging.WARNING)
    return cfg


def get_tokenizer(cfg: RunConfig):
    return load_tokenizer(cfg.data.tokenizer)


def tsv_sources(cfg: RunConfig):
    """img TSV + id2lineidx + txt json (ref: dataset.py:230-246)."""
    data_dir = cfg.data.data_dir
    ds = cfg.data.dataset[0] if cfg.data.dataset else cfg.task.split("-")[0]
    img = TsvImageSource(os.path.join(data_dir, f"img_{ds}.tsv"),
                         os.path.join(data_dir, f"img_{ds}.id2lineidx.pkl"))
    txt = load_txt_json(os.path.join(data_dir, f"txt_{cfg.task}.json"))
    return img, txt


def splits_of(txt: Mapping) -> list[str]:
    return ["train", "val"] + (["test"] if "test" in txt else [])


def all_ranks_take(value):
    """Rank 0's ``value`` on every rank."""
    return all_gather_objects(value)[0]


def rank_loader(cfg: RunConfig, ds, shuffle: bool, **kw) -> ShardedBatchLoader:
    """This rank's loader: ``size_batch / W`` rows of each global batch, its
    rows ``idx[rank::W]`` (JAX ``process_count`` / ``process_index``)."""
    w = process_count()
    return ShardedBatchLoader(ds, per_rank_batch(cfg.train.size_batch, w), shuffle=shuffle,
                              seed=cfg.train.seed, num_hosts=w, host_index=process_index(),
                              num_threads=cfg.data.n_workers, **kw)


def make_loaders(cfg: RunConfig, datasets: dict[str, Any]) -> dict[str, Any]:
    return {split: None if ds is None else rank_loader(cfg, ds, split == "train")
            for split, ds in datasets.items()}


def close_loaders(loaders: Mapping[str, Any]) -> None:
    """Stop every loader's producers (no thread outlives the run)."""
    for ld in loaders.values():
        if ld is not None:
            ld.close()


# ---------------------------------------------------------------- weights

def load_initial_params(cfg: RunConfig, model) -> dict[str, list[str]]:
    """Overlay ``cfg.path_ckpt`` on the model's init (ref: model.py:295-353
    lenient load: intersect what the checkpoint provides, keep the init for
    the rest and where a shape differs, report the unexpected keys). A
    missing ``path_ckpt`` is warned about and the init kept, as the
    reference does (model.py:299-301). Returns the paths of the leaves
    ``loaded``, ``kept`` at init and ``ignored`` (flax paths for a
    ``.msgpack`` / ``.npz``, torch keys for a reference ``.pt``)."""
    report: dict[str, list[str]] = {"loaded": [], "kept": [], "ignored": []}
    path = cfg.path_ckpt
    if path and os.path.exists(path):
        base_sd = model.state_dict()
        if path.endswith(TORCH_SUFFIXES):
            loaded = load_torch_violet_ckpt(path, cfg.model, expected=base_sd)
            merged = _overlay(base_sd, loaded, report)
        else:
            base = convert.flax_from_state_dict(base_sd)
            loaded = _adapt_encoder_layout(base, load_tree(path))
            merged = convert.state_dict_from_flax(_overlay(base, loaded, report))
        model.load_state_dict(merged)
        logger.info("loaded checkpoint %s: %d leaves loaded, %d kept at init, %d ignored",
                    path, *(len(report[k]) for k in ("loaded", "kept", "ignored")))
    elif path:
        logger.warning("checkpoint %s not found, keeping random init "
                       "(ref model.py:299-301 behavior)", path)
    return report


def _adapt_encoder_layout(base, loaded):
    """A checkpoint's layer layouts (per-layer ``layer_i`` / ``blocks_i`` or
    scan-stacked ``layer`` / ``pairs``) converted to the model's, node by
    node (JAX ``cli/common.py:160``)."""
    if not (isinstance(base, Mapping) and isinstance(loaded, Mapping)):
        return loaded
    out = dict(loaded)
    for k, v in base.items():
        lv = loaded.get(k)
        if not (isinstance(v, Mapping) and isinstance(lv, Mapping)):
            continue
        if "layer" in v and "layer_0" in lv:
            out[k] = convert.stack_encoder_params(
                lv, sum(1 for key in lv if key.startswith("layer_")))
        elif "layer_0" in v and "layer" in lv:
            out[k] = convert.unstack_encoder_params(lv)
        elif "pairs" in v and "blocks_0" in lv:
            out[k] = convert.swin_stack_stage_blocks(
                lv, sum(1 for key in lv if key.startswith("blocks_")))
        elif "blocks_0" in v and "pairs" in lv:
            out[k] = convert.swin_unstack_stage_blocks(lv)
        else:
            out[k] = _adapt_encoder_layout(v, lv)
    return out


def _overlay(base, loaded, report: dict[str, list[str]] | None = None, path: str = ""):
    """Recursive key-intersect merge with a shape check (ref:
    model.py:309-341; JAX ``cli/common.py:190``): a leaf the checkpoint has
    at the same shape is taken, any other keeps the init; keys only the
    checkpoint has are logged and left out."""
    report = report if report is not None else {"loaded": [], "kept": [], "ignored": []}
    if not isinstance(base, Mapping):
        if loaded is None:
            report["kept"].append(path)
            return base
        if tuple(np.shape(base)) != tuple(np.shape(loaded)):
            logger.warning("shape mismatch at %s: %s vs %s; keeping init", path,
                           tuple(np.shape(base)), tuple(np.shape(loaded)))
            report["kept"].append(path)
            return base
        report["loaded"].append(path)
        return loaded
    sub = f"{path}." if path else ""
    out = {k: _overlay(v, loaded.get(k) if isinstance(loaded, Mapping) else None, report,
                       f"{sub}{k}") for k, v in base.items()}
    extra = sorted(set(loaded) - set(base)) if isinstance(loaded, Mapping) else []
    if extra:
        logger.info("unexpected checkpoint keys ignored: %s", extra[:10])
        report["ignored"].extend(f"{sub}{k}" for k in extra)
    return out


# the frozen MVM teachers a pretrain model grafts from files, by the
# ModelConfig field naming each file, with the converter of a flax tree
TEACHER_FILES = (("dvae", "dalle_model_path", convert.dvae_state_dict),
                 ("dpt", "midas_model_path", convert.dpt_state_dict),
                 ("raft", "raft_model_path", convert.raft_state_dict),
                 ("clip_model", "clip_model_path", convert.clip_state_dict))


def torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def load_teacher_params(cfg: RunConfig, model) -> None:
    """Load the pretrain model's frozen MVM teachers from their files (ref:
    main_pretrain.py:184-199): a torch ``.pt`` in the teacher's own names
    (HF CLIP's ``vision_model.`` prefix taken off), or a flax ``.msgpack`` /
    ``.npz`` tree through its converter. A teacher with no file stays at
    its random init, with a warning, as in the JAX package."""
    for key, field, convert_tree in TEACHER_FILES:
        module = getattr(model, key, None)
        if module is None:
            continue
        path = getattr(cfg.model, field)
        if not path:
            logger.warning("pretrain model has a %r teacher but no weight path is configured "
                           "— teacher stays at RANDOM init (targets will be meaningless)", key)
            continue
        if path.endswith(TORCH_SUFFIXES):
            sd = torch_state_dict(path)
            sd = {k[len("vision_model."):] if k.startswith("vision_model.") else k: v
                  for k, v in sd.items()}
        else:
            sd = convert_tree(load_tree(path))
        module.load_state_dict({k: sd[k] for k in module.state_dict()})
        logger.info("loaded %s teacher from %s", key, path)
