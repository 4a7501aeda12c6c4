"""Checkpoints (counterpart of ``empirical_mvm_tpu/train/checkpoint.py``;
ref: agent.py:127-141 save_model, model.py:295-353 lenient load).

* ``.msgpack``: the JAX package's native format, a flax param tree in
  flax's msgpack serialisation, written and read by ``core/msgpack.py``
  (the card's machine has no msgpack and no flax). The port writes its
  ``state_dict`` as the flax tree (``models/convert.flax_from_state_dict``)
  and reads a tree into its ``state_dict`` (``state_dict_from_flax``), so
  that each package reads the checkpoints the other writes.
* ``.npz``: the same tree flattened to dotted keys (bf16 leaves as fp32,
  numpy having no bf16).
* ``.pt`` / ``.pth`` / ``.bin``: reference torch checkpoints, through
  :func:`load_torch_violet_ckpt` only.

:func:`save_train_state` / :func:`load_train_state` keep the port's own
resumable state (parameters, AdamW moments, step, and the running
statistics of train-mode BatchNorms) in the same codec, with a
double-buffered write (ref: utils/load_save.py:217-338 TrainingRestorer);
each package resumes its own runs.

Under FSDP (``parallel/mesh.py`` ``shard_model``) every rank calls the
writers, which gather the shards whole (a collective) and leave the writing
to rank 0: the file is the one a replicated run writes. The loaders read the
whole file on every rank and copy each rank its shard.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as op
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from empirical_mvm_torch.core import msgpack
from empirical_mvm_torch.core.retry import retry_io
from empirical_mvm_torch.models.convert import (flax_from_state_dict, per_layer_layout,
                                                remap_swinbert_keys, report_key_diff,
                                                slice_pos_embs, state_dict_from_flax)
from empirical_mvm_torch.parallel.mesh import (fill_from_full, full_state_dict, full_tensor,
                                               is_main_process)
from empirical_mvm_torch.train.train_step import TrainState

logger = logging.getLogger(__name__)

TORCH_SUFFIXES = (".pt", ".pth", ".bin")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _write_meta(path: str, meta: dict | None) -> None:
    if meta is not None:
        with open(op.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def _write_msgpack(obj, path: str, what: str, rotate: bool = False) -> None:
    """``obj`` to ``path`` through a temporary file and a rename; with
    ``rotate`` the file there before is kept as ``path.backup``."""
    tmp = path + ".tmp"

    def write():
        with open(tmp, "wb") as f:
            msgpack.pack(obj, f.write)
        if rotate and op.exists(path):
            os.replace(path, path + ".backup")
        os.replace(tmp, path)

    retry_io(write, what=what)


def _read(path: str) -> bytearray:
    def read():
        with open(path, "rb") as f:
            buf = bytearray(op.getsize(path))
            f.readinto(buf)
            return buf

    return retry_io(read, what=f"ckpt read {path}")


def save_params(params: nn.Module | Mapping[str, torch.Tensor], path: str,
                meta: dict | None = None, heads: Mapping[str, str] | None = None) -> None:
    """A model (or its ``state_dict``) to ``path`` as the flax param tree;
    atomic. ``heads`` as ``flax_from_state_dict`` takes it (by default
    every head, of the kind its structure shows). A sharded model is
    gathered whole, so every rank calls this and rank 0 writes (ref:
    agent.py:134-141)."""
    if not path.endswith((".msgpack", ".npz")):
        raise ValueError(f"unknown checkpoint format: {path}")
    sd = full_state_dict(params) if isinstance(params, nn.Module) else params
    if not is_main_process():
        return
    os.makedirs(op.dirname(op.abspath(path)), exist_ok=True)
    tree = flax_from_state_dict(sd, heads=heads)
    if path.endswith(".msgpack"):
        _write_msgpack(tree, path, f"ckpt write {path}")
    else:
        np.savez(path + ".tmp.npz", **_flatten(tree))
        os.replace(path + ".tmp.npz", path)
    _write_meta(path, meta)


def load_tree(path: str) -> dict:
    """The flax param tree of a ``.msgpack`` or ``.npz`` file as written
    (the JAX ``load_params(path)`` without a template; any layout)."""
    if path.endswith(".msgpack"):
        return msgpack.unpackb(_read(path))
    if path.endswith(".npz"):
        with np.load(path) as z:
            return _unflatten({k: z[k] for k in z.files})
    if path.endswith(TORCH_SUFFIXES):
        raise ValueError("torch checkpoints must go through load_torch_violet_ckpt()")
    raise ValueError(f"unknown checkpoint format: {path}")


def load_params(path: str) -> dict[str, torch.Tensor]:
    """A model checkpoint in either package's layout (per-layer or
    scan-stacked) as the port's ``state_dict`` (CPU tensors)."""
    return state_dict_from_flax(per_layer_layout(load_tree(path)))


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return full_tensor(tree.detach()) if isinstance(tree, torch.Tensor) else tree


def _state_tree(state: TrainState) -> dict:
    """The saved tree; a model with train-mode BatchNorms adds their running
    statistics (``buffers``), which its steps change too."""
    tree = {"params": state.params, "opt_state": state.opt_state, "step": int(state.step)}
    if state.buffers:
        tree["buffers"] = state.buffers
    return tree


def save_train_state(state: TrainState, path: str, meta: dict | None = None) -> None:
    """Full-resume checkpoint: parameters, optimizer state and step. Writes
    ``path`` through a temporary file, then rotates the previous one to
    ``path.backup``. Every rank calls it; rank 0 writes."""
    tree = _whole(_state_tree(state))
    if not is_main_process():
        return
    os.makedirs(op.dirname(op.abspath(path)), exist_ok=True)
    _write_msgpack(tree, path, f"train-state write {path}", rotate=True)
    _write_meta(path, meta)


def _restore_into(like, saved, where: str) -> None:
    """Check that ``saved`` has ``like``'s structure and shapes, then copy."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"train state at {where or 'the root'}: keys differ")
        pairs = [(like[k], saved[k], f"{where}.{k}") for k in like]
        for a, b, w in pairs:
            if isinstance(a, torch.Tensor) and tuple(a.shape) != tuple(np.shape(b)):
                raise ValueError(f"train state {w}: shape {tuple(np.shape(b))}, "
                                 f"not {tuple(a.shape)}")
            if isinstance(a, dict):
                _restore_into(a, b, w)
        return
    raise TypeError(f"train state {where}: not a dict")


def _copy_into(like: dict, saved: dict) -> dict:
    out = {}
    for k, a in like.items():
        b = saved[k]
        if isinstance(a, torch.Tensor):
            fill_from_full(a, b)
            out[k] = a
        elif isinstance(a, dict):
            out[k] = _copy_into(a, b)
        else:
            out[k] = type(a)(b)
    return out


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a :func:`save_train_state` file into ``like``'s tensors (in
    place); falls back to ``path.backup`` where the primary file does not
    restore, and raises ``FileNotFoundError`` where neither does (ref:
    utils/load_save.py restore-with-retry)."""
    want = _state_tree(like)       # shapes of a DTensor are the whole tensor's
    for candidate in (path, path + ".backup"):
        try:
            saved = msgpack.unpackb(_read(candidate))
            _restore_into(want, saved, "")
        except Exception as e:  # noqa: BLE001 — a corrupt or missing buffer
            logger.warning("restore from %s failed: %s", candidate, e)
            continue
        _copy_into(want["params"], saved["params"])
        _copy_into(like.buffers, saved.get("buffers", {}))
        opt_state = _copy_into(like.opt_state, saved["opt_state"])
        return TrainState(params=like.params, opt_state=opt_state, step=int(saved["step"]),
                          buffers=like.buffers)
    raise FileNotFoundError(f"no restorable train state at {path}")


def load_torch_violet_ckpt(path: str, model_cfg,
                           expected: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """A released reference checkpoint (ref: model.py:295-353) as a
    ``state_dict`` in the port's names, which are the reference's:
    ``torch.load`` on the CPU, the trainer wrappers (``state_dict``,
    ``model``, ``module``) and a DDP ``module.`` prefix taken off, the
    SwinBERT keys remapped when the file name says so (ref: model.py:306),
    the position embeddings cut or padded to ``model_cfg``, then, given the
    model's own ``expected`` state_dict, the keys intersected with it and
    the rest reported."""
    sd = torch.load(path, map_location="cpu")
    for wrapper in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    if "SwinBERT" in op.basename(path):
        sd = remap_swinbert_keys(sd)
    sd = slice_pos_embs(sd, model_cfg)
    if expected is not None:
        report_key_diff(set(expected), set(sd))
        sd = {k: v for k, v in sd.items() if k in expected}
    return sd
