"""Weight carry from the JAX package's parameters to the port's state_dict.

:func:`state_dict_from_flax` is the exact inverse of the JAX package's
``models/torch_import.violet_params_from_torch``: it takes the flax param
tree of a ``VioletRetrieval``, a QA model of ``models/tasks.py`` or a
``VioletPretrain`` (nested dicts of arrays) and returns the reference-named
torch ``state_dict`` the port's model of the same name loads. Dense kernels (in, out) become Linear weights (out, in); the patch
kernel (kd, kh, kw, C, E) becomes the Conv3d weight (E, C, kd, kh, kw);
LayerNorm ``scale`` becomes ``weight``; embeddings' ``embedding`` becomes
``weight``. A pretrain tree's frozen ``feature_model`` teacher is carried
too, a ``clip_model`` teacher under HF ``CLIPVisionModel`` names
(:func:`clip_state_dict`, the inverse of the JAX package's
``teachers/clip.clip_params_from_torch``), and the DPT, dVAE and RAFT
teachers under MiDaS, DALL-E and torchvision names (the inverses of the JAX
``dpt_params_from_torch``, ``dvae_params_from_torch`` and
``raft_params_from_torch``).
:func:`swin2d_state_dict_from_hf` loads a HF ``SwinModel`` checkpoint
into the same names: the 2D teacher's real weights (``prefix=
"feature_model."``) or the trained 2D backbone's (``prefix="enc_img.swin."``). This module imports
nothing of JAX: the tree holds numpy arrays (or anything ``np.asarray``
takes).
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


def clip_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``clip_params_from_torch``: a ``CLIPVisual`` tree to HF
    ``CLIPVisionModel`` names without the ``vision_model.`` prefix. The
    (ps * ps * 3, D) patch kernel, rows ordered (i, j, c), becomes the
    (D, 3, ps, ps) conv weight; the fused ``qkv`` Dense splits into
    ``q_proj``, ``k_proj`` and ``v_proj``."""
    p = prefix
    sd: dict = {}
    pk = np.asarray(tree["patch_kernel"])
    d = pk.shape[1]
    ps = int(round((pk.shape[0] // 3) ** 0.5))
    _put(sd, f"{p}embeddings.patch_embedding.weight",
         pk.reshape(ps, ps, 3, d).transpose(3, 2, 0, 1))
    _put(sd, f"{p}embeddings.class_embedding", tree["class_embedding"])
    _put(sd, f"{p}embeddings.position_embedding.weight", tree["position_embedding"])
    _layernorm(sd, f"{p}pre_layrnorm", tree["pre_ln"])
    _layernorm(sd, f"{p}post_layernorm", tree["post_ln"])
    layers = sorted((k for k in tree if k.startswith("layers_")), key=lambda k: int(k[7:]))
    for i, name in enumerate(layers):
        lt, tl = tree[name], f"{p}encoder.layers.{i}"
        _layernorm(sd, f"{tl}.layer_norm1", lt["ln1"])
        _layernorm(sd, f"{tl}.layer_norm2", lt["ln2"])
        kernel, bias = np.asarray(lt["qkv"]["kernel"]), np.asarray(lt["qkv"]["bias"])
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            _linear(sd, f"{tl}.self_attn.{proj}", {"kernel": kernel[:, j * d:(j + 1) * d],
                                                   "bias": bias[j * d:(j + 1) * d]})
        _linear(sd, f"{tl}.self_attn.out_proj", lt["proj"])
        _linear(sd, f"{tl}.mlp.fc1", lt["fc1"])
        _linear(sd, f"{tl}.mlp.fc2", lt["fc2"])
    return sd


def _conv(sd: dict, torch_prefix: str, tree: Tree, w: str = "weight", b: str = "bias") -> None:
    """A flax conv kernel (kh, kw, in, out) as a torch (out, in, kh, kw)
    weight, and its bias where the tree has one."""
    _put(sd, f"{torch_prefix}.{w}", np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in tree:
        _put(sd, f"{torch_prefix}.{b}", tree["bias"])


def dpt_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``dpt_params_from_torch``: a ``DPTDepth`` tree to MiDaS /
    timm names. The reassemble upsamplers' (kh, kw, in, out) kernels become
    torch ``ConvTranspose2d`` (in, out, kh, kw) weights as the JAX importer
    reads them; refinenet4 has no ``resConfUnit1`` (never run, so absent
    from the tree)."""
    p, vit = prefix, f"{prefix}pretrained.model."
    sd: dict = {}
    _conv(sd, f"{vit}patch_embed.proj", tree["patch_embed_proj"])
    _put(sd, f"{vit}cls_token", tree["cls_token"])
    _put(sd, f"{vit}pos_embed", tree["pos_embed"])
    blocks = sorted((k for k in tree if k.startswith("block_")), key=lambda k: int(k[6:]))
    for i, name in enumerate(blocks):
        bt, tb = tree[name], f"{vit}blocks.{i}"
        _layernorm(sd, f"{tb}.norm1", bt["norm1"])
        _layernorm(sd, f"{tb}.norm2", bt["norm2"])
        for flax_name, torch_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                                      ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _linear(sd, f"{tb}.{torch_name}", bt[flax_name])
    for n in range(1, 5):
        ap = f"{p}pretrained.act_postprocess{n}"
        _linear(sd, f"{ap}.0.project.0", tree[f"readout_{n}"])
        _conv(sd, f"{ap}.3", tree[f"reassemble_conv_{n}"])
        if n in (1, 2):
            up = tree[f"reassemble_up_{n}"]
            _put(sd, f"{ap}.4.weight", np.asarray(up["kernel"]).transpose(2, 3, 0, 1))
            _put(sd, f"{ap}.4.bias", up["bias"])
        elif n == 4:
            _conv(sd, f"{ap}.4", tree["reassemble_down_4"])
        _conv(sd, f"{p}scratch.layer{n}_rn", tree[f"layer{n}_rn"])
        rt, rp = tree[f"refinenet{n}"], f"{p}scratch.refinenet{n}"
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in rt:
                for conv in ("conv1", "conv2"):
                    _conv(sd, f"{rp}.{unit}.{conv}", rt[unit][conv])
        _conv(sd, f"{rp}.out_conv", rt["out_conv"])
    for i, name in ((0, "head_conv1"), (2, "head_conv2"), (4, "head_conv3")):
        _conv(sd, f"{p}scratch.output_conv.{i}", tree[name])
    return sd


def dvae_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``dvae_params_from_torch``: a ``DvaeEncoder`` tree to the
    DALL-E encoder's names (``blocks.input.w``, ``blocks.group_{g}.block_{i}.
    {id_path, res_path.conv_{j}}.{w, b}``, ``blocks.output.conv.{w, b}``)."""
    p = f"{prefix}blocks."
    sd: dict = {}

    def conv(torch_prefix, t):
        _conv(sd, torch_prefix, t["conv"], "w", "b")

    conv(f"{p}input", tree["input"])
    for name in (k for k in tree if k.startswith("group_")):
        _, g, _, i = name.split("_")                      # group_{g}_block_{i}
        bt, tb = tree[name], f"{p}group_{g}.block_{i}"
        if "id_path" in bt:
            conv(f"{tb}.id_path", bt["id_path"])
        for j in range(1, 5):
            conv(f"{tb}.res_path.conv_{j}", bt[f"conv_{j}"])
    conv(f"{p}output.conv", tree["output"])
    return sd


def raft_state_dict(tree: Tree, prefix: str = "") -> dict:
    """Inverse of ``raft_params_from_torch``: a ``RAFT`` tree to
    torchvision's ``raft_large`` names; a ``Conv2dNormActivation`` is
    ``{name}.0`` (the conv) and ``{name}.1`` (the batch norm, with its
    ``running_mean`` and ``running_var``)."""
    p = prefix
    sd: dict = {}

    def cna(torch_prefix, t):
        _conv(sd, f"{torch_prefix}.0", t["conv"])
        if "bn" in t:
            for leaf, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                              ("running_var", "var")):
                _put(sd, f"{torch_prefix}.1.{leaf}", t["bn"][key])

    for enc in ("feature_encoder", "context_encoder"):
        et = tree[enc]
        cna(f"{p}{enc}.convnormrelu", et["convnormrelu"])
        _conv(sd, f"{p}{enc}.conv", et["conv"])
        for i in (1, 2, 3):
            for j in (0, 1):
                for part, t in et[f"layer{i}_{j}"].items():
                    cna(f"{p}{enc}.layer{i}.{j}.{part}", t)
    ub = f"{p}update_block"
    for name, t in tree["motion_encoder"].items():
        cna(f"{ub}.motion_encoder.{name}", t)
    for gru, t in tree["recurrent_block"].items():
        for conv, ct in t.items():
            _conv(sd, f"{ub}.recurrent_block.{gru}.{conv}", ct)
    for conv, ct in tree["flow_head"].items():
        _conv(sd, f"{ub}.flow_head.{conv}", ct)
    cna(f"{p}mask_predictor.convrelu", tree["mask_predictor"]["convrelu"])
    _conv(sd, f"{p}mask_predictor.conv", tree["mask_predictor"]["conv"])
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


def enc_img_state_dict(img: Tree, prefix: str = "enc_img.") -> dict:
    """The image encoder's tree: ``EncVideo`` (swin, optional ``fc``, the
    embeddings and ``norm``) or ``EncImgSwin`` (swin, ``swin2bert`` and the
    ``embeds`` block, whose ``emb_odr`` exists for concat fusion only)."""
    p = prefix
    sd = swin3d_state_dict(img["swin"], swin_depths(img["swin"]), f"{p}swin.")
    if "embeds" in img:
        _linear(sd, f"{p}swin2bert", img["swin2bert"])
        emb = img["embeds"]
        for k in ("emb_cls", "emb_pos", "emb_len", "emb_odr"):
            if k in emb:
                _put(sd, f"{p}embeds.{k}", emb[k])
        _layernorm(sd, f"{p}embeds.norm", emb["norm"])
        return sd
    if "fc" in img:
        _linear(sd, f"{p}fc", img["fc"])
    for k in ("emb_cls", "emb_pos", "emb_len", "emb_odr"):
        _put(sd, f"{p}{k}", img[k])
    _layernorm(sd, f"{p}norm", img["norm"])
    return sd


def state_dict_from_flax(params: Tree, cfg: ModelConfig,
                         heads: Mapping[str, str] | None = None) -> dict:
    """JAX ``VioletBase`` params (a retrieval, QA or pretrain model) -> the
    port's ``state_dict``, with an ``EncVideo`` or an ``EncImgSwin``
    (``vis_backbone="swin2d"``) image encoder. ``heads`` maps head names to kinds as in
    ``violet_params_from_torch``, as the JAX CLIs pass them: ``"score_head"``
    (``fc``, ``fc_mvm``), ``"mlm_head"`` (``fc_mtm``) or ``"linear"`` (the
    gumbel selection's bias-free ``vid_key`` and ``vid_query``). The task
    token's ``emb_task`` is carried as it is (the JAX importer has no such
    leaf). A frozen ``feature_model`` teacher in
    the tree is carried under ``feature_model.`` (its depths read from the
    tree; a 2D teacher has no final norm, the 3D one has), a ``clip_model``
    under ``clip_model.`` (:func:`clip_state_dict`), and the ``dpt``,
    ``dvae`` and ``raft`` teachers under their names (:func:`dpt_state_dict`,
    :func:`dvae_state_dict`, :func:`raft_state_dict`)."""
    sd = enc_img_state_dict(params["enc_img"])
    sd.update(bert_embeddings_state_dict(params["enc_txt"]["emb_txt"],
                                         "enc_txt.emb_txt."))
    sd.update(bert_encoder_state_dict(params["trsfr"], cfg.fusion.num_hidden_layers,
                                      "trsfr."))
    if "emb_task" in params:
        _put(sd, "emb_task", params["emb_task"])
    if "feature_model" in params:
        teacher = params["feature_model"]
        sd.update(swin3d_state_dict(teacher, swin_depths(teacher), "feature_model."))
    if "clip_model" in params:
        sd.update(clip_state_dict(params["clip_model"], "clip_model."))
    for name, carry in (("dpt", dpt_state_dict), ("dvae", dvae_state_dict),
                        ("raft", raft_state_dict)):
        if name in params:
            sd.update(carry(params[name], f"{name}."))
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
            _linear(sd, name, tree, bias="bias" in tree)
        else:
            raise NotImplementedError(f"head kind {kind!r} is not ported")
    return sd
