"""Weight carry from the JAX package's parameters to the port's state_dict.

:func:`state_dict_from_flax` is the exact inverse of the JAX package's
``models/torch_import.violet_params_from_torch``: it takes the flax param
tree of a ``VioletRetrieval`` or ``VioletPretrain`` (nested dicts of arrays)
and returns the reference-named torch ``state_dict`` the port's model of the
same name loads. Dense kernels (in, out) become Linear weights (out, in); the patch
kernel (kd, kh, kw, C, E) becomes the Conv3d weight (E, C, kd, kh, kw);
LayerNorm ``scale`` becomes ``weight``; embeddings' ``embedding`` becomes
``weight``. This module imports nothing of JAX: the tree holds numpy arrays
(or anything ``np.asarray`` takes).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from empirical_mvm_torch.core.config import ModelConfig

Tree = Mapping[str, Any]


def _put(sd: dict, key: str, value) -> None:
    sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))


def _linear(sd: dict, torch_prefix: str, tree: Tree, bias: bool = True) -> None:
    _put(sd, f"{torch_prefix}.weight", np.asarray(tree["kernel"]).T)
    if bias:
        _put(sd, f"{torch_prefix}.bias", tree["bias"])


def _layernorm(sd: dict, torch_prefix: str, tree: Tree) -> None:
    _put(sd, f"{torch_prefix}.weight", tree["scale"])
    _put(sd, f"{torch_prefix}.bias", tree["bias"])


def swin3d_state_dict(tree: Tree, depths, prefix: str = "") -> dict:
    """Inverse of ``swin3d_params_from_torch``."""
    sd: dict = {}
    p = prefix
    _put(sd, f"{p}patch_embed.proj.weight",
         np.asarray(tree["patch_embed_proj_kernel"]).transpose(4, 3, 0, 1, 2))
    _put(sd, f"{p}patch_embed.proj.bias", tree["patch_embed_proj_bias"])
    if "patch_embed_norm" in tree:
        _layernorm(sd, f"{p}patch_embed.norm", tree["patch_embed_norm"])
    for i, depth in enumerate(depths):
        stage = tree[f"layers_{i}"]
        for j in range(depth):
            blk, tb = stage[f"blocks_{j}"], f"{p}layers.{i}.blocks.{j}"
            _layernorm(sd, f"{tb}.norm1", blk["norm1"])
            _layernorm(sd, f"{tb}.norm2", blk["norm2"])
            _put(sd, f"{tb}.attn.relative_position_bias_table",
                 blk["attn"]["relative_position_bias_table"])
            _linear(sd, f"{tb}.attn.qkv", blk["attn"]["qkv"])
            _linear(sd, f"{tb}.attn.proj", blk["attn"]["proj"])
            _linear(sd, f"{tb}.mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, f"{tb}.mlp.fc2", blk["mlp"]["fc2"])
        if "downsample" in stage:
            _layernorm(sd, f"{p}layers.{i}.downsample.norm", stage["downsample"]["norm"])
            _linear(sd, f"{p}layers.{i}.downsample.reduction",
                    stage["downsample"]["reduction"], bias=False)
    if "norm" in tree:
        _layernorm(sd, f"{p}norm", tree["norm"])
    return sd


def bert_embeddings_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``bert_embeddings_params_from_torch``."""
    sd: dict = {}
    p = prefix
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        _put(sd, f"{p}{name}.weight", tree[name]["embedding"])
    _layernorm(sd, f"{p}LayerNorm", tree["LayerNorm"])
    return sd


def bert_encoder_state_dict(tree: Tree, num_layers: int, prefix: str = "") -> dict:
    """Inverse of ``bert_encoder_params_from_torch``."""
    sd: dict = {}
    p = prefix
    for i in range(num_layers):
        lt, tl = tree[f"layer_{i}"], f"{p}layer.{i}"
        for name in ("query", "key", "value"):
            _linear(sd, f"{tl}.attention.self.{name}", lt["attention"][name])
        _linear(sd, f"{tl}.attention.output.dense", lt["attention"]["out"])
        _layernorm(sd, f"{tl}.attention.output.LayerNorm", lt["attention"]["LayerNorm"])
        _linear(sd, f"{tl}.intermediate.dense", lt["intermediate"])
        _linear(sd, f"{tl}.output.dense", lt["output"])
        _layernorm(sd, f"{tl}.output.LayerNorm", lt["LayerNorm"])
    return sd


def state_dict_from_flax(params: Tree, cfg: ModelConfig,
                         heads: Mapping[str, str] | None = None) -> dict:
    """JAX ``VioletBase``/``VioletRetrieval``/``VioletPretrain`` params ->
    the port's ``state_dict``. ``heads`` maps head names to kinds as in
    ``violet_params_from_torch``: ``"score_head"``, ``"mlm_head"`` or
    ``"linear"``."""
    img = params["enc_img"]
    sd = swin3d_state_dict(img["swin"], cfg.swin.depths, "enc_img.swin.")
    if "fc" in img:
        _linear(sd, "enc_img.fc", img["fc"])
    for k in ("emb_cls", "emb_pos", "emb_len", "emb_odr"):
        _put(sd, f"enc_img.{k}", img[k])
    _layernorm(sd, "enc_img.norm", img["norm"])
    sd.update(bert_embeddings_state_dict(params["enc_txt"]["emb_txt"],
                                         "enc_txt.emb_txt."))
    sd.update(bert_encoder_state_dict(params["trsfr"], cfg.fusion.num_hidden_layers,
                                      "trsfr."))
    for name, kind in (heads or {}).items():
        tree = params[name]
        if kind == "score_head":
            _linear(sd, f"{name}.1", tree["fc1"])
            _linear(sd, f"{name}.3", tree["fc2"])
        elif kind == "mlm_head":
            # inverse of bert_mlm_head_params_from_torch: HF BertOnlyMLMHead
            # names, the decoder bias as predictions.decoder.bias
            _linear(sd, f"{name}.predictions.transform.dense", tree["transform"])
            _layernorm(sd, f"{name}.predictions.transform.LayerNorm", tree["LayerNorm"])
            _linear(sd, f"{name}.predictions.decoder", tree["decoder"])
        elif kind == "linear":
            _linear(sd, name, tree)
        else:
            raise NotImplementedError(f"head kind {kind!r} is not ported")
    return sd
