"""Config system: typed dataclasses + JSON task files.

The port's own copy of ``empirical_mvm_tpu/core/config.py``: the same
dataclasses, field names and defaults, so the task JSON files in ``configs/``
load unchanged into either package. Field names mirror the reference's
``_args/args_*.json`` keys (ref: utils/args.py:24-231). Knobs that only
select JAX code paths (remat, scan, the Pallas switches, the profiler and
FSDP settings) have no field here, and ``load_run_config`` rejects every key
it does not know, so such a setting fails loudly instead of being dropped.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class SwinConfig:
    """Video Swin 3D backbone hyperparameters.

    Mirrors the mmcv-style configs the reference loads via
    ``Config.fromfile`` (ref: visbackbone/swin_tiny.py:1-24, swin_base.py:1-5,
    swin_violet.py, swin_*_patch244_window877_*.py). All live reference
    configs override ``patch_size=(2,4,4)``; the patch-embed *stride* is
    (1,4,4) (ref: visbackbone/video_swin.py:384) so there is NO temporal
    downsampling.
    """

    patch_size: tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 128
    depths: tuple[int, ...] = (2, 2, 18, 2)
    num_heads: tuple[int, ...] = (4, 8, 16, 32)
    window_size: tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: float | None = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    patch_norm: bool = True
    final_norm: bool = True  # HF 2D Swin hidden_states[-1] is pre-norm

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (len(self.depths) - 1))

    @classmethod
    def tiny(cls) -> "SwinConfig":
        # ref: visbackbone/swin_tiny.py + swin_tiny_patch244_window877_kinetics400_1k.py
        return cls(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
                   drop_path_rate=0.1)

    @classmethod
    def small(cls) -> "SwinConfig":
        return cls(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24),
                   drop_path_rate=0.1)

    @classmethod
    def base(cls) -> "SwinConfig":
        # ref: visbackbone/swin_base.py (embed 128, heads 4/8/16/32)
        return cls()

    @classmethod
    def large(cls) -> "SwinConfig":
        # ref: visbackbone/swin_large.py
        return cls(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48))

    @classmethod
    def violet(cls) -> "SwinConfig":
        # ref: visbackbone/swin_violet.py (embed 96, depths [2,2,18,2])
        return cls(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24))

    @classmethod
    def by_name(cls, name: str) -> "SwinConfig":
        return {"tiny": cls.tiny, "small": cls.small, "base": cls.base,
                "large": cls.large, "violet": cls.violet}[name]()


@dataclass(frozen=True)
class BertConfig:
    """BERT-base config for the text embedder and the cross-modal fusion
    encoder (ref: model.py:85,124 — HF ``bert-base-uncased``)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    @classmethod
    def base_uncased(cls) -> "BertConfig":
        return cls()


@dataclass(frozen=True)
class ModelConfig:
    """Whole-model (VIOLET) architecture config (ref: model.py:117-161,
    utils/args.py model flags)."""

    vis_backbone: str = "vidswin"       # vidswin | swin2d | r50 | merlot
    vis_backbone_size: str = "base"     # tiny | small | base | large | violet
    temporal_fusion: str = "vidswin"    # vidswin | mean | concat
    swinbert: bool = False              # SwinBERT-ckpt compat (ref model.py:27)
    txt_backbone_embed_only: bool = True   # ref: _args/args_pretrain.json:48
    max_size_frame: int = 6             # temporal pos-emb slots (ref: model.py:24)
    max_size_patch: int = 14            # spatial pos-emb side (ref: model.py:23)
    size_img: int = 224
    size_frame: int = 4
    size_txt: int = 32
    size_patch: int = 32                # fusion-token patch (ref: utils/args.py:95)
    size_option: int = 5                # QA-MC options
    size_vocab: int = -1                # open-ended QA answer vocab
    enable_task_token: bool = False     # learned per-task prefix (ref: args.py:131)
    task_token: str = ""                # vtm | mc | oe | cap (ref: args.py:132)
    enable_prompt: bool = False         # encoded text-prompt prefix (ref: args.py:134)
    num_task_tokens: int = 10           # emb_task rows (ref: main_qaoe_lsmdc_fib.py:67)
    r50_train_bn: bool = False          # torch train-mode BN in the R50/merlot
                                        # trunk during training (ref
                                        # resnet50.py:18-21; see BatchNorm2d)
    # MVM teacher weights (ref: main_pretrain.py:184-199). Torch .pt
    # state_dicts are converted on load; msgpack trees load directly.
    vq_on_the_fly: bool = False         # dVAE in the train step vs pre-extracted
    dalle_model_path: str = ""          # ref: utils/args.py:127
    midas_model_path: str = ""          # ref DPT path (main_pretrain.py:190)
    raft_model_path: str = ""           # ref uses torchvision pretrained raft
    clip_model_path: str = ""           # HF CLIPVisionModel .bin/.pt for the
                                        # 2d_clip target (paper's 8th family;
                                        # no reference code branch exists)
    fusion: BertConfig = field(default_factory=BertConfig.base_uncased)
    text: BertConfig = field(default_factory=BertConfig.base_uncased)
    swin_custom: SwinConfig | None = None   # test/research override

    @property
    def swin(self) -> SwinConfig:
        if self.swin_custom is not None:
            return self.swin_custom
        return SwinConfig.by_name(self.vis_backbone_size)

    @property
    def hidden_size(self) -> int:
        return self.fusion.hidden_size

    @property
    def tokens_per_frame(self) -> int:
        hw = self.size_img // self.size_patch
        return 1 + hw * hw  # per-frame CLS + patch tokens (ref: model.py:58-77)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + schedule config (ref: agent.py:13-32,84-113,
    _args/args_*.json)."""

    lr: float = 1.2e-5
    decay: float = 1e-3
    betas: tuple[float, float] = (0.9, 0.98)
    warmup_ratio: float = 0.1
    min_lr: float = 1e-8
    max_grad_norm: float = 1.0
    vis_backbone_lr_mul: float = 1.0
    lr_mult_head: float = 1.0
    size_batch: int = 8
    size_epoch: int = 20
    max_iter: int = -1                  # filled by the agent from loader length
    seed: int = 88
    temp: float = 0.05                  # contrastive / vtm temperature
    p_mask: float = 0.15
    pretrain_tasks: tuple[str, ...] = ("mtm", "vtm", "mvm")
    pretrain_masks: tuple[str, ...] = ("bm", "rm")
    mvm_target: tuple[str, ...] = ("pixel",)
    clip_arch: tuple[int, ...] = (768, 12, 12, 3072)
                                        # 2d_clip teacher (hidden, layers,
                                        # heads, mlp); default CLIP ViT-B/32
    logging_steps: int = 20
    grad_accum: int = 1
    # param-path prefixes excluded from updates (ref: model.py:163-172
    # freeze_vis_encoder/freeze_bert; args.py:59 --freeze_violet maps to
    # ("enc_img", "enc_txt", "trsfr"))
    freeze: tuple[str, ...] = ()


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (ref: dataset.py, utils/args.py data flags)."""

    data_dir: str = "./datasets"
    dataset: tuple[str, ...] = ()
    task: str = ""
    data_ratio: float = 1.0
    n_workers: int = 4
    size_part: int = 8
    img_transform: tuple[str, ...] = ("img_rand_crop",)
    multi_clip_testing: bool = False
    mask_pos: str = "append"            # append | prepend | insert | replace
    tokenizer: str = "bert-base-uncased"
    prompt: str = ""                    # fib prompt text override (ref: main_qaoe_lsmdc_fib.py:24)
    num_beams: int = 1                  # >1: beam-search captioning (ref: main_caption.py:120)
    decode: str = "greedy"              # greedy | top-k | top-p (generation)
    # pre-extracted dVAE tokens for MVM-VQ (ref: main_pretrain.py:27-30):
    # "auto" loads vq_{dataset}.pkl beside the TSVs (cli/extract_vq.py
    # output) when mvm_target includes "vq"; "" disables; else a .pkl path
    vq_path: str = "auto"


@dataclass(frozen=True)
class RunConfig:
    """Top-level config bundling everything for one task run."""

    type: str = "pretrain"              # pretrain | retrieval | qamc | qaoe | caption
    task: str = "pretrain"
    path_output: str = "./_snapshot"
    path_ckpt: str = ""
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _update_dataclass(dc: Any, overrides: dict[str, Any]) -> Any:
    """Recursively apply a flat/nested dict of overrides to a dataclass;
    a key that names no field raises."""
    kwargs: dict[str, Any] = {}
    fields = {f.name for f in dataclasses.fields(dc)}
    unknown = sorted(set(overrides) - fields)
    if unknown:
        raise ValueError(f"unknown {type(dc).__name__} keys: {unknown}")
    for k, v in overrides.items():
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = _update_dataclass(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
            kwargs[k] = tuple(v)
        elif isinstance(cur, tuple) and isinstance(v, str):
            kwargs[k] = (v,)
        else:
            kwargs[k] = v
    return dataclasses.replace(dc, **kwargs)


# Keys the reference keeps at the top level of _args/*.json, mapped to our
# nested dataclasses (ref: utils/args.py:24-150 flag definitions).
_MODEL_KEYS = {"vis_backbone", "vis_backbone_size", "temporal_fusion",
               "txt_backbone_embed_only", "size_img", "size_frame", "size_txt",
               "size_option", "size_vocab", "max_size_frame", "max_size_patch",
               "swinbert", "enable_task_token", "task_token", "enable_prompt",
               "num_task_tokens", "vq_on_the_fly", "dalle_model_path",
               "midas_model_path", "raft_model_path", "clip_model_path"}
_TRAIN_KEYS = {"lr", "decay", "max_grad_norm", "size_batch", "size_epoch",
               "seed", "temp", "p_mask", "pretrain_tasks", "pretrain_masks",
               "mvm_target", "clip_arch", "vis_backbone_lr_mul", "lr_mult_head",
               "logging_steps", "warmup_ratio", "freeze"}
_DATA_KEYS = {"data_dir", "dataset", "task", "data_ratio", "n_workers",
              "size_part", "img_transform", "multi_clip_testing", "mask_pos",
              "tokenizer", "prompt", "num_beams", "decode", "vq_path"}
_TOP_KEYS = {"type", "task", "path_output", "path_ckpt"}
_NESTED_KEYS = {"swin_custom", "fusion", "text", "freeze_violet"}


def validate_run_config(cfg: "RunConfig") -> "RunConfig":
    """Post-parse validation of flag combinations
    (ref: utils/args.py:152-231)."""
    m = cfg.model
    if m.vis_backbone == "vidswin":
        assert m.temporal_fusion == "vidswin", \
            "vidswin backbone requires temporal_fusion=vidswin"
    elif m.vis_backbone in ("swin", "swin2d", "r50"):
        assert m.temporal_fusion in ("mean", "concat"), \
            f"{m.vis_backbone} needs mean/concat fusion (ref args.py:161-184)"
    elif m.vis_backbone == "merlot":
        assert m.temporal_fusion == "concat", \
            "merlot requires temporal_fusion=concat (ref args.py:174)"
    else:
        raise ValueError(f"unknown vis_backbone {m.vis_backbone}")
    assert m.size_img % m.size_patch == 0, \
        f"size_img {m.size_img} must be divisible by size_patch {m.size_patch}"
    if cfg.type == "qaoe" and m.size_vocab <= 0:
        # MLM-head QAOE variants run with size_vocab=-1 (ref args.py:213)
        pass
    assert cfg.train.p_mask <= 1.0
    if m.enable_task_token:
        assert m.task_token in ("vtm", "mc", "oe", "cap"), \
            f"task_token must be one of vtm/mc/oe/cap, got {m.task_token!r}"
    for t in cfg.train.mvm_target:
        assert t in ("vq", "pixel", "hog", "optical_flow", "depth",
                     "3d_feature", "2d_feature", "2d_clip"), t
    for mtype in cfg.train.pretrain_masks:
        assert mtype in ("bm", "am", "rm"), mtype
    return cfg


def load_run_config(path_or_dict: str | dict[str, Any]) -> RunConfig:
    """Build a RunConfig from a reference-style flat JSON task config
    (ref: utils/args.py:14-22 parse_with_config). A key that names no field
    of the port's config raises ``ValueError``."""
    if isinstance(path_or_dict, str):
        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        raw = dict(path_or_dict)
    unknown = sorted(set(raw) - _TOP_KEYS - _NESTED_KEYS - _MODEL_KEYS
                     - _TRAIN_KEYS - _DATA_KEYS)
    if unknown:
        raise ValueError(f"unknown config keys: {unknown}")

    run = RunConfig()
    top = {k: raw[k] for k in _TOP_KEYS if k in raw}
    run = _update_dataclass(run, top)
    model = _update_dataclass(run.model, {k: v for k, v in raw.items() if k in _MODEL_KEYS})
    if "swin_custom" in raw:          # research/test override, nested dict
        model = dataclasses.replace(
            model, swin_custom=_update_dataclass(SwinConfig(), raw["swin_custom"]))
    for bert_key in ("fusion", "text"):
        if bert_key in raw:
            model = dataclasses.replace(
                model, **{bert_key: _update_dataclass(getattr(model, bert_key),
                                                      raw[bert_key])})
    train = _update_dataclass(run.train,
                              {k: v for k, v in raw.items() if k in _TRAIN_KEYS})
    if raw.get("freeze_violet"):        # reference bool flag (ref: args.py:59)
        train = dataclasses.replace(
            train, freeze=tuple(sorted(set(train.freeze)
                                       | {"enc_img", "enc_txt", "trsfr"})))
    run = dataclasses.replace(
        run,
        model=model,
        train=train,
        data=_update_dataclass(run.data, {k: v for k, v in raw.items() if k in _DATA_KEYS}),
    )
    return validate_run_config(run)
