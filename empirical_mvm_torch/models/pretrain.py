"""VIOLET pretraining model for the pixel and 2d_feature MVM targets: MTM +
VTM + MVM (counterpart of ``empirical_mvm_tpu/models/pretrain.py``; ref:
main_pretrain.py:140-267).

As in the JAX package, the VTM negatives are vectorised: each row pairs its
video with its own caption (the positive, read from the MTM pass) and O-1
other captions, and the B*(O-1) negative pairs ride one ``go_cross`` call
with the B masked pairs. The pixel decoder is a Linear on the fused patch
tokens followed by the channel-major pixel shuffle. The 2d_feature target
regresses, through the ``fc_mvm`` score head, the features of a frozen 2D
Swin-base teacher (``feature_model``, run frame by frame on the unmasked
clip under no_grad, its LayerNorms through the kernel; ref:
main_pretrain.py:164-174, 527-545).

The video backbone is the Video Swin (``vidswin``) or the trained 2D Swin
(``swin2d``, concat fusion; mean fusion keeps one averaged frame of video
tokens and so takes no MVM task). The other MVM targets, ``smtm`` and ``am``
masking are not ported.
"""

from __future__ import annotations

import torch

from empirical_mvm_torch.core.config import ModelConfig, RunConfig
from empirical_mvm_torch.data.masking import MaskDraws, apply_masking, draw_masks
from empirical_mvm_torch.models.bert import BertMLMHead
from empirical_mvm_torch.models.common import Linear, init_weights
from empirical_mvm_torch.models.encoders2d import swin2d_config
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.models.violet import ScoreHead, VioletBase
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.train.losses import cross_entropy_ignore, masked_l1


def pixel_shuffle_tokens(x: torch.Tensor, r: int, out_ch: int) -> torch.Tensor:
    """(B, T, h, w, out_ch*r*r) -> (B, T, h*r, w*r, out_ch), the channel-major
    layout of torch PixelShuffle (ref: main_pretrain.py:178)."""
    b, t, h, w, _ = x.shape
    x = x.reshape(b, t, h, w, out_ch, r, r).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h * r, w * r, out_ch)


def draw_negatives(gen: torch.Generator, b: int, k: int) -> torch.Tensor:
    """(B, k) in-batch negative captions per row, never the row's own: the k
    largest of uniform scores with the diagonal pushed down."""
    scores = torch.rand((b, b), generator=gen, device=gen.device)
    scores = scores - 2.0 * torch.eye(b, device=gen.device)
    return scores.topk(k, dim=1).indices


class VioletPretrain(VioletBase):
    """(ref: main_pretrain.py:140-267)

    Built on ``device`` (the card unless the caller asks for the CPU) with
    parameters drawn from ``seed``; load a converted checkpoint with
    ``load_state_dict`` to replace them.
    """

    special_token_ids = (101, 102, 0)     # [CLS], [SEP], [PAD] of bert-base
    mask_token_id = 103
    num_options = 4                       # VTM: 1 positive + 3 in-batch negatives
    mvm_targets_ported = ("pixel", "2d_feature")

    def __init__(self, config: ModelConfig, *, mvm_target=("pixel",),
                 pretrain_tasks=("mtm", "vtm", "mvm"), pretrain_masks=("bm", "rm"),
                 p_mask: float = 0.15, temp: float = 0.05,
                 dtype=torch.float32, device="cuda", seed: int = 0):
        if not set(mvm_target) <= set(self.mvm_targets_ported):
            raise NotImplementedError(f"mvm_target {tuple(mvm_target)}: only "
                                      f"{self.mvm_targets_ported} are ported")
        if not set(pretrain_tasks) <= {"mtm", "vtm", "mvm"}:
            raise NotImplementedError(f"pretrain_tasks {tuple(pretrain_tasks)}: "
                                      "smtm is not ported")
        if config.temporal_fusion == "mean" and "mvm" in pretrain_tasks:
            raise ValueError("MVM predicts every frame's patches, and mean temporal fusion "
                             "leaves one averaged frame of video tokens: use concat fusion "
                             "or drop the mvm task")
        device = torch.device(device)
        with device:
            super().__init__(config, dtype)
            d, ps = config.hidden_size, config.size_patch
            self.fc = ScoreHead(d, dtype=dtype)
            self.fc_mtm = BertMLMHead(config.fusion, dtype)
            if "pixel" in mvm_target:
                self.decoder_pixel = Linear(d, ps * ps * 3, compute_dtype=dtype)
            if "2d_feature" in mvm_target:
                teacher = swin2d_config("base")
                self.fc_mvm = ScoreHead(d, teacher.num_features, dtype)
                self.feature_model = SwinTransformer3D(teacher, dtype, fused_norms=True)
                self.feature_model.requires_grad_(False)
        self.mvm_target = tuple(mvm_target)
        self.pretrain_tasks = tuple(pretrain_tasks)
        self.pretrain_masks = tuple(pretrain_masks)
        self.p_mask, self.temp = p_mask, temp
        init_weights(self, torch.Generator(device).manual_seed(seed))

    @classmethod
    def from_run_config(cls, run: RunConfig, **kwargs) -> "VioletPretrain":
        """The model a pretrain task file (``configs/pretrain.json``) names."""
        t = run.train
        return cls(run.model, mvm_target=t.mvm_target, pretrain_tasks=t.pretrain_tasks,
                   pretrain_masks=t.pretrain_masks, p_mask=t.p_mask, temp=t.temp, **kwargs)

    def patch_tokens(self, out_mvm, t, h, w):
        """Drop the per-frame CLS, return the (B, T, h, w, D) grid
        (ref: main_pretrain.py:391,425)."""
        b, _, d = out_mvm.shape
        return out_mvm.reshape(b, t, 1 + h * w, d)[:, :, 1:].reshape(b, t, h, w, d)

    def decode_pixel(self, grid):
        return pixel_shuffle_tokens(self.decoder_pixel(grid), self.config.size_patch, 3)

    def forward(self, img, txt, mask, neg_idx=None, generator=None):
        """One pretrain forward (ref: main_pretrain.py:226-267) on a masked
        batch. ``neg_idx`` (B, O-1) names each row's negative captions; with
        O = min(B, num_options) > 1 it is required. Returns the MTM logits,
        the fused video tokens and the VTM logits (positive first)."""
        b, t = img.shape[:2]
        h = w = img.shape[2] // self.config.size_patch
        o = min(b, self.num_options)
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        if o > 1:
            if neg_idx is None or neg_idx.shape != (b, o - 1):
                raise ValueError(f"neg_idx must be ({b}, {o - 1})")
            flat = neg_idx.reshape(-1)
            all_out = self.go_cross(
                torch.cat([fi, fi.repeat_interleave(o - 1, 0)]),
                torch.cat([mi, mi.repeat_interleave(o - 1, 0)]),
                torch.cat([ft, ft[flat]]), torch.cat([mt, mt[flat]]), generator)
            out, p_out = all_out[:b], all_out[b:]
        else:
            out, p_out = self.go_cross(fi, mi, ft, mt, generator), None
        lv = fi.shape[1]                  # t * (1 + h * w), one frame under mean fusion
        out_mvm, out_txt = out[:, :lv], out[:, lv:]
        out_vtm = self.fc(out[:, lv], generator)                     # (B, 1)
        if p_out is not None:
            neg = self.fc(p_out[:, lv], generator).reshape(b, o - 1)
            out_vtm = torch.cat([out_vtm, neg], dim=1)
        return {"out_mtm": self.fc_mtm(out_txt), "out_mvm": out_mvm, "out_vtm": out_vtm}

    def losses(self, img, txt, mask, *, generator=None, mask_generator=None,
               draws: MaskDraws | None = None, neg_idx=None) -> dict:
        """Masking, forward and every loss of one pretrain step
        (ref: main_pretrain.py:276-372, 374-553, 555-569).

        ``img`` is the unmasked clip, uint8 or normalized float. Masks and
        negatives are drawn from ``mask_generator`` unless ``draws`` and
        ``neg_idx`` are given; ``generator`` drives dropout and stochastic
        depth (None: the deterministic pass).
        """
        img = maybe_normalize(img)
        b, t = img.shape[:2]
        ps = self.config.size_patch
        h, w = img.shape[2] // ps, img.shape[3] // ps
        if draws is None:
            draws = draw_masks(mask_generator, txt, t, h, w,
                               special_token_ids=self.special_token_ids,
                               mask_token_id=self.mask_token_id, p_mask=self.p_mask,
                               mask_types=self.pretrain_masks)
        mb = apply_masking(draws, img, txt, mask_token_id=self.mask_token_id, patch_size=ps)
        o = min(b, self.num_options)
        if neg_idx is None and o > 1:
            neg_idx = draw_negatives(mask_generator, b, o - 1)
        out = self(mb.img, mb.txt, mask, neg_idx, generator)
        ls = {"mtm": cross_entropy_ignore(out["out_mtm"], mb.ans_mtm),
              "vtm": cross_entropy_ignore(out["out_vtm"] / self.temp,
                                          torch.zeros(b, dtype=torch.int64,
                                                      device=img.device))}
        if "mvm" in self.pretrain_tasks:
            grid = self.patch_tokens(out["out_mvm"], t, h, w)
            if "pixel" in self.mvm_target:
                ls["mvm_pixel"] = masked_l1(self.decode_pixel(grid), img, mb.mvm_mask,
                                            channel_div=3.0)
            if "2d_feature" in self.mvm_target:
                with torch.no_grad():               # the frozen teacher, unmasked clip
                    target = self.feature_model(img)
                ls["mvm_2d_feature"] = masked_l1(self.fc_mvm(grid, generator), target,
                                                 mb.cov[..., None], channel_div=3.0)
        ls["total"] = sum(ls.values())
        return ls
