"""Weight layouts between the JAX package's flax parameter trees and the
port's ``state_dict``, both ways.

:func:`state_dict_from_flax` is the exact inverse of the JAX package's
``models/torch_import.violet_params_from_torch``: it takes the flax param
tree of a ``VioletRetrieval``, a QA model of ``models/tasks.py``, a
``VioletCaptioning`` or a ``VioletPretrain`` (nested dicts of arrays) and
returns the reference-named torch ``state_dict`` the port's model of the
same name loads. :func:`flax_from_state_dict` is its inverse: the tree the
JAX package builds, saves and loads, from a port ``state_dict``. Both walk
one per-leaf map (:class:`_Map`): each leaf is named once, by its torch key,
its flax path and the transform between them (an axis permutation, a
reshape, a slice of a fused leaf), so that the two directions cannot drift.
Dense kernels (in, out) become Linear weights (out, in); the patch kernel
(kd, kh, kw, C, E) becomes the Conv3d weight (E, C, kd, kh, kw); LayerNorm
``scale`` becomes ``weight``; embeddings' ``embedding`` becomes ``weight``.
A pretrain tree's frozen ``feature_model`` teacher is carried too, a
``clip_model`` teacher under HF ``CLIPVisionModel`` names
(:func:`clip_state_dict`, the inverse of the JAX package's
``teachers/clip.clip_params_from_torch``), and the DPT, dVAE and RAFT
teachers under MiDaS, DALL-E and torchvision names (the inverses of the JAX
``dpt_params_from_torch``, ``dvae_params_from_torch`` and
``raft_params_from_torch``). The heads are found by their structure where
the caller names none: a score head (``fc1``, ``fc2``), an MLM head
(``transform``, ``LayerNorm``, ``decoder``) or a plain Dense (``kernel``).

Floating leaves come out fp32, but bf16 stays bf16; a flax leaf is a numpy
array (a ``torch.bfloat16`` tensor where it is bf16, as
``core/msgpack.py`` reads it).

:func:`swin2d_state_dict_from_hf` loads a HF ``SwinModel`` checkpoint
into the same names: the 2D teacher's real weights (``prefix=
"feature_model."``) or the trained 2D backbone's (``prefix="enc_img.swin."``).
:func:`resnet50_state_dict_from_torchvision` and :func:`vit_state_dict_from_hf`
load a torchvision ResNet-50 and a HF ``ViTModel.encoder`` into the R50 and
MERLOT encoders' names (the JAX ``resnet50_params_from_torch`` and
``vit_encoder_params_from_hf``).

The rest is the lenient half of the JAX ``models/torch_import.py`` and the
scan layouts of its models: :func:`slice_pos_embs`,
:func:`remap_swinbert_keys`, :func:`report_key_diff`,
:func:`inflate_swin2d_to_3d` (on torch-named ``state_dict`` entries), and
the readers of the scan-stacked BERT and Swin layouts
(:func:`unstack_encoder_params`, :func:`swin_unstack_stage_blocks` and the
stacking inverses). This module imports nothing of JAX: the tree holds
numpy arrays (or anything ``np.asarray`` takes).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Mapping

import numpy as np
import torch

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.encoders2d import ResNet50

logger = logging.getLogger(__name__)

Tree = Mapping[str, Any]

TRUNK = ("enc_img", "enc_txt", "trsfr", "emb_task")
TEACHER_TREES = ("feature_model", "clip_model", "dpt", "dvae", "raft")


def _tensor(x) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor: floating fp32, bf16 kept."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
    else:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":              # ml_dtypes, a JAX array
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point() and t.dtype != torch.bfloat16:
        t = t.float()
    return t.contiguous()


def _leaf_out(t: torch.Tensor):
    """A flax leaf: numpy, or the bf16 tensor."""
    t = t.contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _put(sd: dict, key: str, value) -> None:
    sd[key] = _tensor(value)


class _Map:
    """One pass over the per-leaf map. With ``tree`` it builds the
    ``state_dict`` (``forward``); with ``sd`` the flax tree. Structure
    (which optional leaves exist, how many layers) is read from whichever
    side is given: :meth:`has` takes the flax path and the torch key of the
    same thing."""

    def __init__(self, tree: Tree | None = None, sd: Mapping[str, Any] | None = None):
        self.tree, self.sd = tree, sd
        self.forward = tree is not None
        self.out: dict = {}
        self.parts: dict[str, list] = {}
        if not self.forward:
            self._prefixes = set()
            for k in sd:
                parts = k.split(".")
                self._prefixes.update(".".join(parts[:i]) for i in range(1, len(parts)))

    def node(self, fpath: str):
        node = self.tree
        for k in fpath.split("."):
            if not isinstance(node, Mapping) or k not in node:
                return None
            node = node[k]
        return node

    def has(self, fpath: str, tkey: str) -> bool:
        if self.forward:
            return self.node(fpath) is not None
        return tkey in self.sd or tkey in self._prefixes

    def count(self, fpath: Callable[[int], str], tkey: Callable[[int], str],
              start: int = 0) -> int:
        n = start
        while self.has(fpath(n), tkey(n)):
            n += 1
        return n - start

    def names(self, fpath: str, tprefix: str) -> list[str]:
        """Children of a node whose names are the same on both sides."""
        if self.forward:
            return list(self.node(fpath))
        out: dict[str, None] = {}
        for k in self.sd:
            if k.startswith(tprefix + "."):
                out[k[len(tprefix) + 1:].split(".")[0]] = None
        return list(out)

    def shape(self, fpath: str, tkey: str) -> tuple[int, ...]:
        return tuple((self.node(fpath) if self.forward else self.sd[tkey]).shape)

    def leaf(self, tkey: str, fpath: str, perm=None, view=None, part=None) -> None:
        """``tkey`` is the flax leaf at ``fpath``, sliced by ``part`` (axis,
        start, stop), reshaped by ``view`` (flax shape, torch shape) and
        permuted by ``perm``."""
        if self.forward:
            x = self.node(fpath)
            if x is None:
                raise KeyError(f"no leaf {fpath!r} in the flax tree")
            t = _tensor(x)
            if part is not None:
                axis, a, b = part
                t = t.narrow(axis, a, b - a)
            if view is not None:
                t = t.reshape(view[1])
            if perm is not None:
                t = t.permute(perm)
            self.out[tkey] = t.contiguous()
            return
        t = _tensor(self.sd[tkey])
        if perm is not None:
            t = t.permute(tuple(int(i) for i in np.argsort(perm)))
        if view is not None:
            t = t.reshape(view[0])
        if part is None:
            _set(self.out, fpath, _leaf_out(t))
        else:
            self.parts.setdefault(fpath, []).append((part, t))

    def result(self) -> dict:
        for fpath, pieces in self.parts.items():
            axis = pieces[0][0][0]
            pieces.sort(key=lambda p: p[0][1])
            _set(self.out, fpath, _leaf_out(torch.cat([t for _, t in pieces], axis)))
        return self.out


def _set(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _linear(m: _Map, fp: str, tp: str, bias: bool = True) -> None:
    m.leaf(f"{tp}.weight", f"{fp}.kernel", perm=(1, 0))
    if bias and m.has(f"{fp}.bias", f"{tp}.bias"):
        m.leaf(f"{tp}.bias", f"{fp}.bias")


def _layernorm(m: _Map, fp: str, tp: str) -> None:
    m.leaf(f"{tp}.weight", f"{fp}.scale")
    m.leaf(f"{tp}.bias", f"{fp}.bias")


def _conv(m: _Map, fp: str, tp: str, w: str = "weight", b: str = "bias") -> None:
    """A flax conv kernel (kh, kw, in, out) as a torch (out, in, kh, kw)
    weight, and its bias where there is one."""
    m.leaf(f"{tp}.{w}", f"{fp}.kernel", perm=(3, 2, 0, 1))
    if m.has(f"{fp}.bias", f"{tp}.{b}"):
        m.leaf(f"{tp}.{b}", f"{fp}.bias")


def _swin3d(m: _Map, fp: str, tp: str, depths=None) -> None:
    """``swin3d_params_from_torch`` (``relative_position_index`` buffers are
    regenerated, not loaded, as in the reference)."""
    m.leaf(f"{tp}patch_embed.proj.weight", f"{fp}patch_embed_proj_kernel",
           perm=(4, 3, 0, 1, 2))
    m.leaf(f"{tp}patch_embed.proj.bias", f"{fp}patch_embed_proj_bias")
    if m.has(f"{fp}patch_embed_norm", f"{tp}patch_embed.norm"):
        _layernorm(m, f"{fp}patch_embed_norm", f"{tp}patch_embed.norm")
    if depths is None:
        n = m.count(lambda i: f"{fp}layers_{i}", lambda i: f"{tp}layers.{i}")
        depths = [m.count(lambda j, i=i: f"{fp}layers_{i}.blocks_{j}",
                          lambda j, i=i: f"{tp}layers.{i}.blocks.{j}") for i in range(n)]
    for i, depth in enumerate(depths):
        for j in range(depth):
            fb, tb = f"{fp}layers_{i}.blocks_{j}", f"{tp}layers.{i}.blocks.{j}"
            _layernorm(m, f"{fb}.norm1", f"{tb}.norm1")
            _layernorm(m, f"{fb}.norm2", f"{tb}.norm2")
            m.leaf(f"{tb}.attn.relative_position_bias_table",
                   f"{fb}.attn.relative_position_bias_table")
            for name in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
                _linear(m, f"{fb}.{name}", f"{tb}.{name}")
        fd, td = f"{fp}layers_{i}.downsample", f"{tp}layers.{i}.downsample"
        if m.has(fd, td):
            _layernorm(m, f"{fd}.norm", f"{td}.norm")
            _linear(m, f"{fd}.reduction", f"{td}.reduction", bias=False)
    if m.has(f"{fp}norm", f"{tp}norm"):
        _layernorm(m, f"{fp}norm", f"{tp}norm")


def _clip(m: _Map, fp: str, tp: str) -> None:
    """``clip_params_from_torch``: the (ps * ps * 3, D) patch kernel, rows
    ordered (i, j, c), is the (D, 3, ps, ps) conv weight; the fused ``qkv``
    Dense splits into ``q_proj``, ``k_proj`` and ``v_proj``."""
    pk, pw = f"{fp}patch_kernel", f"{tp}embeddings.patch_embedding.weight"
    shape = m.shape(pk, pw)
    if m.forward:
        d = shape[1]
        ps = int(round((shape[0] // 3) ** 0.5))
    else:
        d, ps = shape[0], shape[2]
    m.leaf(pw, pk, perm=(3, 2, 0, 1), view=((ps * ps * 3, d), (ps, ps, 3, d)))
    m.leaf(f"{tp}embeddings.class_embedding", f"{fp}class_embedding")
    m.leaf(f"{tp}embeddings.position_embedding.weight", f"{fp}position_embedding")
    _layernorm(m, f"{fp}pre_ln", f"{tp}pre_layrnorm")
    _layernorm(m, f"{fp}post_ln", f"{tp}post_layernorm")
    for i in range(m.count(lambda i: f"{fp}layers_{i}", lambda i: f"{tp}encoder.layers.{i}")):
        fl, tl = f"{fp}layers_{i}", f"{tp}encoder.layers.{i}"
        _layernorm(m, f"{fl}.ln1", f"{tl}.layer_norm1")
        _layernorm(m, f"{fl}.ln2", f"{tl}.layer_norm2")
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            part = (j * d, (j + 1) * d)
            m.leaf(f"{tl}.self_attn.{proj}.weight", f"{fl}.qkv.kernel", perm=(1, 0),
                   part=(1, *part))
            m.leaf(f"{tl}.self_attn.{proj}.bias", f"{fl}.qkv.bias", part=(0, *part))
        _linear(m, f"{fl}.proj", f"{tl}.self_attn.out_proj")
        _linear(m, f"{fl}.fc1", f"{tl}.mlp.fc1")
        _linear(m, f"{fl}.fc2", f"{tl}.mlp.fc2")


def _dpt(m: _Map, fp: str, tp: str) -> None:
    """``dpt_params_from_torch``: MiDaS / timm names. The reassemble
    upsamplers' (kh, kw, in, out) kernels are torch ``ConvTranspose2d``
    (in, out, kh, kw) weights as the JAX importer reads them; refinenet4
    has no ``resConfUnit1`` (never run, so absent from the tree)."""
    vit = f"{tp}pretrained.model."
    _conv(m, f"{fp}patch_embed_proj", f"{vit}patch_embed.proj")
    m.leaf(f"{vit}cls_token", f"{fp}cls_token")
    m.leaf(f"{vit}pos_embed", f"{fp}pos_embed")
    for i in range(m.count(lambda i: f"{fp}block_{i}", lambda i: f"{vit}blocks.{i}")):
        fb, tb = f"{fp}block_{i}", f"{vit}blocks.{i}"
        _layernorm(m, f"{fb}.norm1", f"{tb}.norm1")
        _layernorm(m, f"{fb}.norm2", f"{tb}.norm2")
        for flax_name, torch_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _linear(m, f"{fb}.{flax_name}", f"{tb}.{torch_name}")
    for n in range(1, 5):
        ap = f"{tp}pretrained.act_postprocess{n}"
        _linear(m, f"{fp}readout_{n}", f"{ap}.0.project.0")
        _conv(m, f"{fp}reassemble_conv_{n}", f"{ap}.3")
        if n in (1, 2):
            m.leaf(f"{ap}.4.weight", f"{fp}reassemble_up_{n}.kernel", perm=(2, 3, 0, 1))
            m.leaf(f"{ap}.4.bias", f"{fp}reassemble_up_{n}.bias")
        elif n == 4:
            _conv(m, f"{fp}reassemble_down_4", f"{ap}.4")
        _conv(m, f"{fp}layer{n}_rn", f"{tp}scratch.layer{n}_rn")
        rf, rp = f"{fp}refinenet{n}", f"{tp}scratch.refinenet{n}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            if m.has(f"{rf}.{unit}", f"{rp}.{unit}"):
                for conv in ("conv1", "conv2"):
                    _conv(m, f"{rf}.{unit}.{conv}", f"{rp}.{unit}.{conv}")
        _conv(m, f"{rf}.out_conv", f"{rp}.out_conv")
    for i, name in ((0, "head_conv1"), (2, "head_conv2"), (4, "head_conv3")):
        _conv(m, f"{fp}{name}", f"{tp}scratch.output_conv.{i}")


def _dvae(m: _Map, fp: str, tp: str) -> None:
    """``dvae_params_from_torch``: the DALL-E encoder's names
    (``blocks.input.w``, ``blocks.group_{g}.block_{i}.{id_path,
    res_path.conv_{j}}.{w, b}``, ``blocks.output.conv.{w, b}``)."""
    p = f"{tp}blocks."

    def conv(f, t):
        _conv(m, f"{f}.conv", t, "w", "b")

    conv(f"{fp}input", f"{p}input")
    for g in range(1, 1 + m.count(lambda g: f"{fp}group_{g}_block_1",
                                  lambda g: f"{p}group_{g}.block_1", start=1)):
        for i in range(1, 1 + m.count(lambda i, g=g: f"{fp}group_{g}_block_{i}",
                                      lambda i, g=g: f"{p}group_{g}.block_{i}", start=1)):
            fb, tb = f"{fp}group_{g}_block_{i}", f"{p}group_{g}.block_{i}"
            if m.has(f"{fb}.id_path", f"{tb}.id_path"):
                conv(f"{fb}.id_path", f"{tb}.id_path")
            for j in range(1, 5):
                conv(f"{fb}.conv_{j}", f"{tb}.res_path.conv_{j}")
    conv(f"{fp}output", f"{p}output.conv")


def _raft(m: _Map, fp: str, tp: str) -> None:
    """``raft_params_from_torch``: torchvision's ``raft_large`` names; a
    ``Conv2dNormActivation`` is ``{name}.0`` (the conv) and ``{name}.1``
    (the batch norm, with its ``running_mean`` and ``running_var``)."""

    def cna(f, t):
        _conv(m, f"{f}.conv", f"{t}.0")
        if m.has(f"{f}.bn", f"{t}.1"):
            for leaf, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                              ("running_var", "var")):
                m.leaf(f"{t}.1.{leaf}", f"{f}.bn.{key}")

    for enc in ("feature_encoder", "context_encoder"):
        fe, te = f"{fp}{enc}", f"{tp}{enc}"
        cna(f"{fe}.convnormrelu", f"{te}.convnormrelu")
        _conv(m, f"{fe}.conv", f"{te}.conv")
        for i in (1, 2, 3):
            for j in (0, 1):
                fl, tl = f"{fe}.layer{i}_{j}", f"{te}.layer{i}.{j}"
                for part in m.names(fl, tl):
                    cna(f"{fl}.{part}", f"{tl}.{part}")
    ub = f"{tp}update_block"
    for name in m.names(f"{fp}motion_encoder", f"{ub}.motion_encoder"):
        cna(f"{fp}motion_encoder.{name}", f"{ub}.motion_encoder.{name}")
    for gru in m.names(f"{fp}recurrent_block", f"{ub}.recurrent_block"):
        fg, tg = f"{fp}recurrent_block.{gru}", f"{ub}.recurrent_block.{gru}"
        for conv in m.names(fg, tg):
            _conv(m, f"{fg}.{conv}", f"{tg}.{conv}")
    for conv in m.names(f"{fp}flow_head", f"{ub}.flow_head"):
        _conv(m, f"{fp}flow_head.{conv}", f"{ub}.flow_head.{conv}")
    cna(f"{fp}mask_predictor.convrelu", f"{tp}mask_predictor.convrelu")
    _conv(m, f"{fp}mask_predictor.conv", f"{tp}mask_predictor.conv")


def _bert_embeddings(m: _Map, fp: str, tp: str) -> None:
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        m.leaf(f"{tp}{name}.weight", f"{fp}{name}.embedding")
    _layernorm(m, f"{fp}LayerNorm", f"{tp}LayerNorm")


def _bert_encoder(m: _Map, fp: str, tp: str, num_layers: int | None = None) -> None:
    if num_layers is None:
        num_layers = m.count(lambda i: f"{fp}layer_{i}", lambda i: f"{tp}layer.{i}")
    for i in range(num_layers):
        fl, tl = f"{fp}layer_{i}", f"{tp}layer.{i}"
        for name in ("query", "key", "value"):
            _linear(m, f"{fl}.attention.{name}", f"{tl}.attention.self.{name}")
        _linear(m, f"{fl}.attention.out", f"{tl}.attention.output.dense")
        _layernorm(m, f"{fl}.attention.LayerNorm", f"{tl}.attention.output.LayerNorm")
        _linear(m, f"{fl}.intermediate", f"{tl}.intermediate.dense")
        _linear(m, f"{fl}.output", f"{tl}.output.dense")
        _layernorm(m, f"{fl}.LayerNorm", f"{tl}.output.LayerNorm")


def _batch_norm(m: _Map, fp: str, tp: str) -> None:
    """BatchNorm: flax ``scale``, ``bias``, ``mean``, ``var`` (the JAX
    package keeps the running statistics among its parameters) as torch's
    ``weight``, ``bias`` and the ``running_mean``, ``running_var`` buffers."""
    for leaf, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                      ("running_var", "var")):
        m.leaf(f"{tp}.{leaf}", f"{fp}.{key}")


def _resnet50(m: _Map, fp: str, tp: str) -> None:
    """``resnet50_params_from_torch``'s tree (``conv1``, ``bn1``,
    ``layer{l}_{i}.{conv,bn}{1-3}``, ``down_conv``, ``down_bn``) in
    torchvision's names (``layer{l}.{i}``, ``downsample.0`` / ``.1``); conv
    kernels (kh, kw, in, out) as (out, in, kh, kw) weights."""
    _conv(m, f"{fp}conv1", f"{tp}conv1")
    _batch_norm(m, f"{fp}bn1", f"{tp}bn1")
    for li, (_, n, _) in enumerate(ResNet50.STAGES, start=1):
        for bi in range(n):
            fb, tb = f"{fp}layer{li}_{bi}", f"{tp}layer{li}.{bi}"
            for ci in (1, 2, 3):
                _conv(m, f"{fb}.conv{ci}", f"{tb}.conv{ci}")
                _batch_norm(m, f"{fb}.bn{ci}", f"{tb}.bn{ci}")
            if m.has(f"{fb}.down_conv", f"{tb}.downsample"):
                _conv(m, f"{fb}.down_conv", f"{tb}.downsample.0")
                _batch_norm(m, f"{fb}.down_bn", f"{tb}.downsample.1")


def _vit_blocks(m: _Map, fp: str, tp: str) -> None:
    """The MERLOT encoder's ViT blocks, flax ``vit_{i}.{norm1, qkv, proj,
    norm2, fc1, fc2}`` as the timm names of ``teachers/dpt.ViTBlock``
    (``vit.{i}.attn.qkv``, ``mlp.fc1``, ...)."""
    for i in range(m.count(lambda i: f"{fp}vit_{i}", lambda i: f"{tp}vit.{i}")):
        fb, tb = f"{fp}vit_{i}", f"{tp}vit.{i}"
        _layernorm(m, f"{fb}.norm1", f"{tb}.norm1")
        _layernorm(m, f"{fb}.norm2", f"{tb}.norm2")
        for flax_name, torch_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _linear(m, f"{fb}.{flax_name}", f"{tb}.{torch_name}")


def _enc_img(m: _Map, fp: str, tp: str) -> None:
    """``EncVideo`` (swin, optional ``fc``, the embeddings and ``norm``; in
    the SwinBERT layout swin, ``fc`` and ``img_embedding``, which the JAX
    importer does not read), ``EncImgSwin`` (swin, ``swin2bert`` and the
    ``embeds`` block, whose ``emb_odr`` exists for concat fusion only),
    ``EncImgR50`` (``res``, ``proj``, ``embeds``) or ``EncImgMerlot``
    (those, the ViT blocks and ``out_norm``)."""
    embs = ("emb_cls", "emb_pos", "emb_len", "emb_odr")
    if m.has(f"{fp}img_embedding", f"{tp}img_embedding"):
        _swin3d(m, f"{fp}swin.", f"{tp}swin.")
        _linear(m, f"{fp}fc", f"{tp}fc")
        _linear(m, f"{fp}img_embedding", f"{tp}img_embedding")
        return
    if m.has(f"{fp}res", f"{tp}res"):
        _resnet50(m, f"{fp}res.", f"{tp}res.")
        _linear(m, f"{fp}proj", f"{tp}proj")
        _vit_blocks(m, fp, tp)
        if m.has(f"{fp}out_norm", f"{tp}out_norm"):
            _layernorm(m, f"{fp}out_norm", f"{tp}out_norm")
    else:
        _swin3d(m, f"{fp}swin.", f"{tp}swin.")
    if m.has(f"{fp}embeds", f"{tp}embeds"):
        if m.has(f"{fp}swin2bert", f"{tp}swin2bert"):
            _linear(m, f"{fp}swin2bert", f"{tp}swin2bert")
        for k in embs:
            if m.has(f"{fp}embeds.{k}", f"{tp}embeds.{k}"):
                m.leaf(f"{tp}embeds.{k}", f"{fp}embeds.{k}")
        _layernorm(m, f"{fp}embeds.norm", f"{tp}embeds.norm")
        return
    if m.has(f"{fp}fc", f"{tp}fc"):
        _linear(m, f"{fp}fc", f"{tp}fc")
    for k in embs:
        m.leaf(f"{tp}{k}", f"{fp}{k}")
    _layernorm(m, f"{fp}norm", f"{tp}norm")


def _head_kind(m: _Map, name: str) -> str:
    if m.has(f"{name}.fc1", f"{name}.1"):
        return "score_head"
    if m.has(f"{name}.transform", f"{name}.predictions"):
        return "mlm_head"
    if m.has(f"{name}.kernel", f"{name}.weight"):
        return "linear"
    raise ValueError(f"{name!r} is no head this map knows")


def _head(m: _Map, name: str, kind: str) -> None:
    if kind == "score_head":
        _linear(m, f"{name}.fc1", f"{name}.1")
        _linear(m, f"{name}.fc2", f"{name}.3")
    elif kind == "mlm_head":
        # HF BertOnlyMLMHead names, the decoder bias as predictions.decoder.bias
        _linear(m, f"{name}.transform", f"{name}.predictions.transform.dense")
        _layernorm(m, f"{name}.LayerNorm", f"{name}.predictions.transform.LayerNorm")
        _linear(m, f"{name}.decoder", f"{name}.predictions.decoder")
    elif kind == "linear":
        _linear(m, name, name)
    else:
        raise NotImplementedError(f"head kind {kind!r} is not ported")


def _top_names(m: _Map) -> list[str]:
    if m.forward:
        return list(m.tree)
    return list(dict.fromkeys(k.split(".")[0] for k in m.sd))


def _violet(m: _Map, heads: Mapping[str, str] | None, fusion_layers: int | None,
            text_layers: int | None) -> None:
    _enc_img(m, "enc_img.", "enc_img.")
    _bert_embeddings(m, "enc_txt.emb_txt.", "enc_txt.emb_txt.")
    if m.has("enc_txt.txt_trsfr", "enc_txt.txt_trsfr"):
        _bert_encoder(m, "enc_txt.txt_trsfr.", "enc_txt.txt_trsfr.", text_layers)
    _bert_encoder(m, "trsfr.", "trsfr.", fusion_layers)
    if m.has("emb_task", "emb_task"):
        m.leaf("emb_task", "emb_task")
    for name, walk in (("feature_model", _swin3d), ("clip_model", _clip), ("dpt", _dpt),
                       ("dvae", _dvae), ("raft", _raft)):
        if m.has(name, name):
            walk(m, f"{name}.", f"{name}.")
    if heads is None:
        heads = {n: _head_kind(m, n) for n in _top_names(m)
                 if n not in TRUNK + TEACHER_TREES}
    for name, kind in heads.items():
        _head(m, name, kind)


def _forward(tree: Tree, walk, *args) -> dict:
    m = _Map(tree=tree)
    walk(m, *args)
    return m.result()


def _inverse(sd: Mapping[str, Any], walk, *args) -> dict:
    m = _Map(sd=sd)
    walk(m, *args)
    return m.result()


def swin3d_state_dict(tree: Tree, depths, prefix: str = "") -> dict:
    """Inverse of ``swin3d_params_from_torch``."""
    return _forward(tree, _swin3d, "", prefix, depths)


def swin_depths(tree: Tree) -> tuple[int, ...]:
    """Blocks per stage of a swin param tree (``layers_i.blocks_j``)."""
    stages = sorted((k for k in tree if k.startswith("layers_")), key=lambda k: int(k[7:]))
    return tuple(sum(1 for k in tree[s] if k.startswith("blocks_")) for s in stages)


# HF SwinLayer module -> the port's block module, for those mapped one to one
_HF_SWIN_BLOCK = {"layernorm_before": "norm1", "layernorm_after": "norm2",
                  "attention.output.dense": "attn.proj", "intermediate.dense": "mlp.fc1",
                  "output.dense": "mlp.fc2"}


def swin2d_state_dict_from_hf(hf: Mapping[str, Any], depths, prefix: str = "") -> dict:
    """HF ``transformers.SwinModel`` state_dict -> the port's
    ``SwinTransformer3D`` names at ``swin2d_config`` geometry, under
    ``prefix`` (``"feature_model."`` for the teacher): the counterpart of the JAX
    ``swin2d_params_from_hf``. A 2D Swin is the 3D module one frame deep:
    the (E, 3, 4, 4) patch kernel gains a unit temporal axis, and the
    (169, nH) bias table and its index coincide with the 3D ones at wd = 1.
    HF's separate query/key/value concatenate into ``qkv``. The final
    ``layernorm`` is not mapped: the reference consumes
    ``hidden_states[-1]``, which is taken before it (visbackbone/swin.py:75).
    """
    p = prefix
    sd: dict = {}
    _put(sd, f"{p}patch_embed.proj.weight",
         np.asarray(hf["embeddings.patch_embeddings.projection.weight"])[:, :, None])
    _put(sd, f"{p}patch_embed.proj.bias", hf["embeddings.patch_embeddings.projection.bias"])
    for leaf in ("weight", "bias"):
        _put(sd, f"{p}patch_embed.norm.{leaf}", hf[f"embeddings.norm.{leaf}"])
    for i, depth in enumerate(depths):
        for j in range(depth):
            hb, tb = f"encoder.layers.{i}.blocks.{j}", f"{p}layers.{i}.blocks.{j}"
            for hn, tn in _HF_SWIN_BLOCK.items():
                for leaf in ("weight", "bias"):
                    _put(sd, f"{tb}.{tn}.{leaf}", hf[f"{hb}.{hn}.{leaf}"])
            _put(sd, f"{tb}.attn.relative_position_bias_table",
                 hf[f"{hb}.attention.self.relative_position_bias_table"])
            for leaf in ("weight", "bias"):
                _put(sd, f"{tb}.attn.qkv.{leaf}", np.concatenate(
                    [np.asarray(hf[f"{hb}.attention.self.{qkv}.{leaf}"])
                     for qkv in ("query", "key", "value")], 0))
        hd, td = f"encoder.layers.{i}.downsample", f"{p}layers.{i}.downsample"
        if f"{hd}.norm.weight" in hf:
            for leaf in ("weight", "bias"):
                _put(sd, f"{td}.norm.{leaf}", hf[f"{hd}.norm.{leaf}"])
            _put(sd, f"{td}.reduction.weight", hf[f"{hd}.reduction.weight"])
    return sd


def resnet50_state_dict_from_torchvision(tv: Mapping[str, Any],
                                         prefix: str = "enc_img.res.") -> dict:
    """A torchvision ``resnet50`` state_dict -> the port's ``ResNet50``
    trunk under ``prefix``: the counterpart of the JAX
    ``resnet50_params_from_torch``. The names are torchvision's already;
    ``fc`` (the trunk drops it) and ``num_batches_tracked`` (torch's
    counter, which the momentum rule does not read) are left out."""
    return {f"{prefix}{k}": _tensor(v) for k, v in tv.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}


def vit_state_dict_from_hf(hf: Mapping[str, Any], num_layers: int,
                           prefix: str = "enc_img.vit.") -> dict:
    """HF ``ViTModel.encoder`` state_dict (``layer.{i}.attention.attention.
    {query,key,value}``, ``layernorm_before``, ...) -> the MERLOT encoder's
    timm-named blocks under ``prefix``, query, key and value concatenated
    into ``attn.qkv``: the counterpart of the JAX
    ``vit_encoder_params_from_hf`` (ref: visbackbone/merlot.py:41-49)."""
    sd: dict = {}
    for i in range(num_layers):
        hl, tb = f"layer.{i}", f"{prefix}{i}"
        for hn, tn in (("layernorm_before", "norm1"), ("layernorm_after", "norm2"),
                       ("attention.output.dense", "attn.proj"),
                       ("intermediate.dense", "mlp.fc1"), ("output.dense", "mlp.fc2")):
            for leaf in ("weight", "bias"):
                _put(sd, f"{tb}.{tn}.{leaf}", hf[f"{hl}.{hn}.{leaf}"])
        for leaf in ("weight", "bias"):
            _put(sd, f"{tb}.attn.qkv.{leaf}", np.concatenate(
                [np.asarray(hf[f"{hl}.attention.attention.{qkv}.{leaf}"])
                 for qkv in ("query", "key", "value")], 0))
    return sd


def clip_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``clip_params_from_torch``: a ``CLIPVisual`` tree to HF
    ``CLIPVisionModel`` names without the ``vision_model.`` prefix."""
    return _forward(tree, _clip, "", prefix)


def dpt_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``dpt_params_from_torch``: a ``DPTDepth`` tree to MiDaS /
    timm names."""
    return _forward(tree, _dpt, "", prefix)


def dvae_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``dvae_params_from_torch``: a ``DvaeEncoder`` tree to the
    DALL-E encoder's names."""
    return _forward(tree, _dvae, "", prefix)


def raft_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``raft_params_from_torch``: a ``RAFT`` tree to
    torchvision's ``raft_large`` names."""
    return _forward(tree, _raft, "", prefix)


def bert_embeddings_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``bert_embeddings_params_from_torch``."""
    return _forward(tree, _bert_embeddings, "", prefix)


def bert_encoder_state_dict(tree: Tree, num_layers: int, prefix: str = "") -> dict:
    """Inverse of ``bert_encoder_params_from_torch``."""
    return _forward(tree, _bert_encoder, "", prefix, num_layers)


def enc_img_state_dict(img: Tree, prefix: str = "enc_img.") -> dict:
    """The image encoder's tree: ``EncVideo``, ``EncImgSwin``, ``EncImgR50``
    or ``EncImgMerlot``."""
    return _forward(img, _enc_img, "", prefix)


def state_dict_from_flax(params: Tree, cfg: ModelConfig | None = None,
                         heads: Mapping[str, str] | None = None) -> dict:
    """JAX ``VioletBase`` params (a retrieval, QA, captioning or pretrain
    model) -> the port's ``state_dict``, with an ``EncVideo``, an
    ``EncImgSwin`` (``vis_backbone="swin2d"``), an ``EncImgR50`` or an
    ``EncImgMerlot`` image encoder (BatchNorm ``mean`` / ``var`` as the
    ``running_*`` buffers). ``heads`` maps
    head names to kinds as in ``violet_params_from_torch``, as the JAX CLIs
    pass them: ``"score_head"`` (``fc``, ``fc_mvm``), ``"mlm_head"``
    (``fc_mtm``) or ``"linear"`` (the decoders, the gumbel selection's
    bias-free ``vid_key`` and ``vid_query``); only those heads are carried.
    Without ``heads`` every other top-level subtree is a head, of the kind
    its structure shows. ``cfg`` gives the fusion depth (else it is counted
    in the tree). The task token's ``emb_task`` is carried as it is (the
    JAX importer has no such leaf). A frozen ``feature_model`` teacher in
    the tree is carried under ``feature_model.`` (its depths read from the
    tree; a 2D teacher has no final norm, the 3D one has), a ``clip_model``
    under ``clip_model.``, and the ``dpt``, ``dvae`` and ``raft`` teachers
    under their names. A text stack (``enc_txt.txt_trsfr``) is carried in
    HF ``BertEncoder`` names, its depth ``cfg.text``'s (else counted), and
    the SwinBERT video layout's ``fc`` and ``img_embedding``."""
    return _forward(params, _violet, heads, *_depths(cfg))


def flax_from_state_dict(sd: Mapping[str, Any], cfg: ModelConfig | None = None,
                         heads: Mapping[str, str] | None = None) -> dict:
    """The inverse of :func:`state_dict_from_flax`: a port ``state_dict``
    (a model's, or a checkpoint's in its names) -> the JAX package's flax
    param tree, in the per-layer layout (no scan stacking)."""
    return _inverse(sd, _violet, heads, *_depths(cfg))


def _depths(cfg: ModelConfig | None) -> tuple[int | None, int | None]:
    """The fusion's and the text stack's depths, or None (counted)."""
    return (None, None) if cfg is None else (cfg.fusion.num_hidden_layers,
                                             cfg.text.num_hidden_layers)


# -------------------------------------------------------------------------
# the lenient load of reference checkpoints (JAX models/torch_import.py)

def _cat(parts, axis):
    return torch.cat([torch.as_tensor(p) for p in parts], axis)


def slice_pos_embs(sd: Mapping[str, Any], model_cfg: ModelConfig) -> dict:
    """Temporal / spatial position embeddings cut or zero-padded to the
    model's ``max_size_frame`` and ``1 + max_size_patch ** 2`` (ref:
    model.py:342-353; JAX ``torch_import._slice_pos_embs``)."""
    out = dict(sd)
    for key, want, axis in (("enc_img.emb_len", model_cfg.max_size_frame, 1),
                            ("enc_img.emb_pos", 1 + model_cfg.max_size_patch ** 2, 2)):
        if key not in out:
            continue
        v = torch.as_tensor(out[key])
        have = v.shape[axis]
        if have > want:
            out[key] = v.narrow(axis, 0, want)
        elif have < want:
            pad = list(v.shape)
            pad[axis] = want - have
            out[key] = _cat([v, torch.zeros(pad, dtype=v.dtype)], axis)
            logger.warning("%s padded %d -> %d", key, have, want)
    return out


def remap_swinbert_keys(sd: Mapping[str, Any]) -> dict:
    """SwinBERT -> VIOLET key remap (ref: model.py:355-386)."""
    out: dict = {}
    dropped = []
    for key, val in sd.items():
        if "swin.backbone" in key:
            out[key.replace("swin.backbone", "enc_img.swin")] = val
        elif "trans_encoder.bert.encoder" in key:
            out[key.replace("trans_encoder.bert.encoder", "trsfr")] = val
        elif "trans_encoder.bert.embeddings" in key:
            out[key.replace("trans_encoder.bert.embeddings", "enc_txt.emb_txt")] = val
        elif key.startswith("fc."):
            out[key.replace("fc.", "enc_img.fc.")] = val
        elif "trans_encoder.bert.img_embedding" in key:
            out[key.replace("trans_encoder.bert.img_embedding", "enc_img.img_embedding")] = val
        elif key.startswith("trans_encoder.cls."):
            out[key.replace("trans_encoder.cls.", "fc_mtm.")] = val
        else:
            dropped.append(key)
    if "fc_mtm.predictions.bias" in out:
        out["fc_mtm.predictions.decoder.bias"] = out["fc_mtm.predictions.bias"]
    if dropped:
        logger.info("SwinBERT remap dropped %d keys", len(dropped))
    return out


def report_key_diff(expected: set[str], loaded: set[str]) -> tuple[set[str], set[str]]:
    """Log the missing and unexpected keys (ref: model.py:309-341); returns
    (missing, unexpected)."""
    unexpected = loaded - expected
    missing = expected - loaded
    if unexpected:
        logger.warning("Unexpected checkpoint keys (%d): %s",
                       len(unexpected), sorted(unexpected)[:20])
    if missing:
        logger.warning("Missing checkpoint keys (%d): %s", len(missing), sorted(missing)[:20])
    return missing, unexpected


def inflate_swin2d_to_3d(sd: Mapping[str, Any], window_size: tuple[int, int, int] = (8, 7, 7),
                         patch_t: int = 2) -> dict:
    """An ImageNet 2D Swin ``state_dict`` in the 3D layout (ref:
    visbackbone/video_swin.py:484-536 ``inflate_weights``): the patch
    kernel (E, C, kh, kw) repeated ``patch_t`` times along a new temporal
    axis and divided by ``patch_t``; each ``relative_position_bias_table``
    (L1, nH) resized bicubically (``interpolate(mode="bicubic")``, as the JAX
    package does) to the 3D spatial window where the 2D window differs,
    then tiled ``2 * wd - 1`` times along the temporal offsets; the
    ``relative_position_index`` and ``attn_mask`` buffers dropped."""
    wd, wh, ww = window_size
    out: dict = {}
    for k, v in sd.items():
        if "relative_position_index" in k or "attn_mask" in k:
            continue
        v = torch.as_tensor(v)
        if k.endswith("patch_embed.proj.weight"):
            v = v[:, :, None].repeat(1, 1, patch_t, 1, 1) / patch_t
        elif k.endswith("relative_position_bias_table"):
            l1, nh = v.shape
            l2 = (2 * wh - 1) * (2 * ww - 1)
            if l1 != l2:
                s1 = int(round(l1 ** 0.5))
                t = v.float().permute(1, 0).reshape(1, nh, s1, s1)
                t = torch.nn.functional.interpolate(t, size=(2 * wh - 1, 2 * ww - 1),
                                                    mode="bicubic")
                v = t.reshape(nh, l2).permute(1, 0)
            v = v.repeat(2 * wd - 1, 1)
        out[k] = v
    return out


# -------------------------------------------------------------------------
# scan layouts: the JAX package's scanned BERT encoder keeps its layers
# stacked under "layer", its scanned Swin stages their blocks in pairs
# under "pairs" (models/bert.py:268-285, models/video_swin.py:612-637). The
# port has no scan: it reads both layouts and writes the per-layer one.

def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def stack_encoder_params(per_layer: Tree, num_layers: int) -> dict:
    """{'layer_0': tree, ...} -> {'layer': stacked tree}: the inverse of
    :func:`unstack_encoder_params` (JAX ``models/bert.py:268``)."""
    return {"layer": _tree_map(_stack, *(per_layer[f"layer_{i}"] for i in range(num_layers)))}


def unstack_encoder_params(stacked: Tree) -> dict:
    """{'layer': (L, ...) tree} -> {'layer_i': tree}: the inverse of
    :func:`stack_encoder_params` (JAX ``models/bert.py:277``)."""
    n = int(_first_leaf(stacked["layer"]).shape[0])
    return {f"layer_{i}": _tree_map(lambda x, i=i: x[i], stacked["layer"]) for i in range(n)}


def swin_stack_stage_blocks(stage: Tree, depth: int) -> dict:
    """Per-block stage params -> the scanned layout {'pairs': {'blk0':
    stacked evens, 'blk1': stacked odds}, ...}; the inverse of
    :func:`swin_unstack_stage_blocks` (JAX ``models/video_swin.py:612``)."""
    out = {k: v for k, v in stage.items() if not k.startswith("blocks_")}
    out["pairs"] = {
        "blk0": _tree_map(_stack, *(stage[f"blocks_{i}"] for i in range(0, depth, 2))),
        "blk1": _tree_map(_stack, *(stage[f"blocks_{i}"] for i in range(1, depth, 2)))}
    return out


def swin_unstack_stage_blocks(stage: Tree) -> dict:
    """The scanned layout -> per-block stage params; the inverse of
    :func:`swin_stack_stage_blocks` (JAX ``models/video_swin.py:626``)."""
    out = {k: v for k, v in stage.items() if k != "pairs"}
    pairs = stage["pairs"]
    n = int(_first_leaf(pairs["blk0"]).shape[0])
    for i in range(n):
        out[f"blocks_{2 * i}"] = _tree_map(lambda x, i=i: x[i], pairs["blk0"])
        out[f"blocks_{2 * i + 1}"] = _tree_map(lambda x, i=i: x[i], pairs["blk1"])
    return out


def per_layer_layout(tree: Tree):
    """Every scan-stacked encoder (a node with ``layer``) and Swin stage (a
    node with ``pairs``) in ``tree`` unstacked."""
    if not isinstance(tree, Mapping):
        return tree
    if "layer" in tree and isinstance(tree["layer"], Mapping):
        tree = {**{k: v for k, v in tree.items() if k != "layer"},
                **unstack_encoder_params(tree)}
    if "pairs" in tree:
        tree = swin_unstack_stage_blocks(tree)
    return {k: per_layer_layout(v) for k, v in tree.items()}
