"""Pretraining CLI (counterpart of ``empirical_mvm_tpu/cli/pretrain.py``;
ref: main_pretrain.py / main_pretrain_yaml.py): multi-dataset MVM
pretraining over sharded TSVs with the MetaLoader schedule, the val losses
at startup and every half epoch, and the final checkpoint.

Usage:
  python -m empirical_mvm_torch.cli.pretrain --config configs/pretrain.json
  python -m torch.distributed.run --nproc_per_node=N -m empirical_mvm_torch.cli.pretrain \
      --config configs/pretrain.json       # N cards, size_batch the global batch
"""

from __future__ import annotations

import json
import os
import pickle

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.data.composite import CompositeYamlDataset
from empirical_mvm_torch.data.datasets import PretrainTsvDataset
from empirical_mvm_torch.data.loader import MetaLoader
from empirical_mvm_torch.models.pretrain import VioletPretrain
from empirical_mvm_torch.parallel.mesh import all_gather_objects
from empirical_mvm_torch.train.agent import PretrainAgent


def build_model(cfg, tokzr, device, dtype=common.DTYPE) -> VioletPretrain:
    """The pretrain model of ``cfg`` with the tokenizer's special ids."""
    model = VioletPretrain.from_run_config(cfg, dtype=dtype, device=device, seed=cfg.train.seed)
    model.special_token_ids = (tokzr.cls_token_id, tokzr.sep_token_id, tokzr.pad_token_id)
    model.mask_token_id = tokzr.mask_token_id
    return model


def _vq_table(cfg, ds_name: str):
    """Pre-extracted dVAE tokens (``cli/extract_vq.py``; ref:
    main_pretrain.py:27-30) where the vq target runs without the dVAE:
    ``data.vq_path``, or with ``"auto"`` ``vq_{dataset}.pkl`` beside the
    TSVs when it exists."""
    if "vq" not in cfg.train.mvm_target or cfg.model.vq_on_the_fly:
        return None
    path = cfg.data.vq_path
    if path == "auto":
        path = os.path.join(cfg.data.data_dir, f"vq_{ds_name}.pkl")
        if not os.path.exists(path):
            path = ""
    if not path:
        return None
    with open(path, "rb") as f:
        return pickle.load(f)


def train_loaders(cfg, tokzr) -> dict:
    """One loader a train shard ``{name}_train_{part}.tsv`` (ref:
    main_pretrain.py:44-47), or a ``{name}.yaml`` composite with shard
    affinity (ref: main_pretrain_yaml.py:10-105); weight 1 each."""
    loaders = {}
    for ds_name in cfg.data.dataset:
        yaml_path = os.path.join(cfg.data.data_dir, f"{ds_name}.yaml")
        if ds_name.endswith(".yaml") or os.path.exists(yaml_path):
            ds = CompositeYamlDataset(cfg, ds_name if ds_name.endswith(".yaml") else yaml_path,
                                      split="train", tokzr=tokzr)
            loaders[ds_name] = (common.rank_loader(cfg, ds, True,
                                                   source_idx=ds.get_composite_source_idx()), 1)
            continue
        with open(os.path.join(cfg.data.data_dir, f"txt_{ds_name}.json")) as f:
            txt = json.load(f)
        vq = _vq_table(cfg, ds_name)
        parts = [p for p in (os.path.join(cfg.data.data_dir, f"{ds_name}_train_{part}.tsv")
                             for part in range(cfg.data.size_part)) if os.path.exists(p)]
        if not parts:
            raise FileNotFoundError(f"no train shards for {ds_name} under {cfg.data.data_dir}")
        for i, p in enumerate(parts):
            ds = PretrainTsvDataset(cfg, "train", tokzr, p, txt.get("train", txt),
                                    dataset_name=ds_name, vq=vq)
            loaders[f"{ds_name}/{i}"] = (common.rank_loader(cfg, ds, True), 1)
    return loaders


def val_loaders(cfg, tokzr) -> dict:
    """(ref: main_pretrain_yaml.py:168-176,286-293) Per dataset a
    ``{name}_val.yaml`` composite, or ``{name}_val_{part}.tsv`` shards with
    ``txt["val"]`` captions; a dataset without val data is left out of the
    eval, as in the JAX package."""
    out = {}
    for ds_name in cfg.data.dataset:
        stem = ds_name[:-len(".yaml")] if ds_name.endswith(".yaml") else ds_name
        val_yaml = os.path.join(cfg.data.data_dir, f"{stem}_val.yaml")
        if os.path.exists(val_yaml):
            ds = CompositeYamlDataset(cfg, val_yaml, split="val", tokzr=tokzr)
            out[f"{stem}_val"] = common.rank_loader(cfg, ds, False)
            continue
        txt_path = os.path.join(cfg.data.data_dir, f"txt_{stem}.json")
        if not os.path.exists(txt_path):
            continue
        with open(txt_path) as f:
            txt_all = json.load(f)
        for part in range(cfg.data.size_part):
            p = os.path.join(cfg.data.data_dir, f"{stem}_val_{part}.tsv")
            if os.path.exists(p):
                ds = PretrainTsvDataset(cfg, "val", tokzr, p, txt_all.get("val", txt_all),
                                        dataset_name=stem)
                out[f"{stem}_val/{part}"] = common.rank_loader(cfg, ds, False)
    return out


def main(argv=None, *, device="cuda", decode=None) -> dict:
    device = common.run_device(device, decode)
    cfg = common.setup_run(common.parse_cli(__doc__, argv), device)
    tokzr = common.get_tokenizer(cfg)
    tc = cfg.train
    loaders = train_loaders(cfg, tokzr)
    meta = MetaLoader(loaders, seed=tc.seed, accum_steps=tc.grad_accum)
    vals = val_loaders(cfg, tokzr)
    try:
        model = build_model(cfg, tokzr, device)
        report = common.load_initial_params(cfg, model)
        common.load_teacher_params(cfg, model)
        # shard affinity can give the ranks different row counts: every rank
        # runs the fewest steps, so that their collectives stay in step
        steps_per_ep = min(all_gather_objects(sum(len(ld) for ld, _ in loaders.values())))
        num_steps = steps_per_ep * tc.size_epoch
        agent = PretrainAgent(cfg, model, device=device, decode=decode,
                              max_iter=max(num_steps, 1))
        eval_fn = agent.make_val_fn(vals) if vals else None
        if agent.resume():
            num_steps = max(num_steps - agent.global_step, 0)
        agent.run_meta(meta, num_steps, eval_every=max(steps_per_ep // 2, 1), eval_fn=eval_fn)
        agent.save(num_steps, tag="pretrain_final")
    finally:
        meta.close()
        common.close_loaders(vals)
    return {"run_dir": cfg.path_output, "load": report, "steps": agent.global_step,
            "steps_per_epoch": steps_per_ep}


if __name__ == "__main__":
    main()
