"""VIOLET pretraining model: MTM + VTM + MVM with the pixel, hog, vq,
depth, optical_flow, 3d_feature, 2d_feature and 2d_clip targets
(counterpart of ``empirical_mvm_tpu/models/pretrain.py``; ref:
main_pretrain.py:140-267).

As in the JAX package, the VTM negatives are vectorised: each row pairs its
video with its own caption (the positive, read from the MTM pass) and O-1
other captions, and the B*(O-1) negative pairs ride one ``go_cross`` call
with the B masked pairs. The pixel, hog and depth decoders are a Linear on
the fused patch tokens followed by the channel-major pixel shuffle; the
flow decoder reads adjacent frames' tokens side by side. The hog target is
:func:`hog_image` of the unmasked clip. The other targets come from frozen
teachers run on the unmasked clip under no_grad, their LayerNorms and
attention through the kernels where they have any: depth a DPT-Large per
frame (``dpt``), optical_flow RAFT on adjacent frame pairs (``raft``; pairs
whose flow reaches 50 pixels are left out of the loss), vq on the fly the
dVAE's tokens per frame (``dvae``; each 8 x 8 cell's answer where the pixel
cover touches it), classified from the shuffled ``decoder_vq`` output
(ref: main_pretrain.py:178-209, 386-506); pre-extracted vq classifies the
fused video tokens against the given tokens. The feature targets regress,
through a score head, 3d_feature a Video Swin-base's and 2d_feature a 2D
Swin-base's features (``fc_mvm``, ``feature_model``; with both targets, as
in the JAX package's ``if 3d ... elif 2d``, the one teacher is the 3D one
and both losses read it), 2d_clip a CLIP ViT-B/32's frame by frame
(``fc_mvm_clip``, ``clip_model``; ref: main_pretrain.py:153-174, 508-545).

The video backbone is the Video Swin (``vidswin``), the trained 2D Swin
(``swin2d``), the ResNet-50 (``r50``) or the MERLOT encoder (``merlot``);
the 2D ones with concat fusion (mean fusion keeps one averaged frame of
video tokens and so takes no MVM task). The ``smtm`` task fuses the masked
caption once more under the ``seq2seq`` joint mask and scores the MLM head
there against the MTM answers (ref: main_pretrain.py:253-258). A clip the
loader marks ``corrupt`` is zeroed after normalization and left out of the
hog loss. ``am`` masking draws its slots from the attention rollout of one
more deterministic pass over the unmasked batch, under no_grad
(:meth:`VioletPretrain.get_att`; ref: main_pretrain.py:211-215, 320-343).

Data parallel (``parallel.mesh.data_parallel``), the negatives are drawn for
the global batch and index the captions of every rank, gathered in global
order with their gradient, and O = min(global B, num_options), as one
process over the global batch does.

``losses`` opens the tracer's spans (``core/tracing.py``): ``pretrain.masking``
around the draws (the ``am`` pass included) and the masking, and
``pretrain.teacher`` around each no-grad target pass (the feature teacher,
DPT, CLIP, RAFT and the dVAE).
"""

from __future__ import annotations

import torch

from empirical_mvm_torch.core import tracing
from empirical_mvm_torch.core.config import ModelConfig, RunConfig, SwinConfig
from empirical_mvm_torch.data.masking import MaskDraws, apply_masking, draw_masks
from empirical_mvm_torch.models.bert import BertMLMHead
from empirical_mvm_torch.models.common import Linear, init_weights
from empirical_mvm_torch.models.encoders2d import swin2d_config
from empirical_mvm_torch.models.video_swin import SwinTransformer3D
from empirical_mvm_torch.models.violet import ScoreHead, VioletBase, joint_attn_bias
from empirical_mvm_torch.ops.hog import hog_image
from empirical_mvm_torch.ops.preprocess import maybe_normalize
from empirical_mvm_torch.parallel.mesh import gather_rows, global_rows, local_rows
from empirical_mvm_torch.teachers.clip import CLIPVisual, renormalize_imagenet_to_clip
from empirical_mvm_torch.teachers.dpt import DPTDepth
from empirical_mvm_torch.teachers.dvae import DvaeEncoder
from empirical_mvm_torch.teachers.raft import RAFT
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
    ``load_state_dict`` to replace them. ``clip_arch`` is the 2d_clip
    teacher's (hidden, layers, heads, mlp); hidden is also the width
    ``fc_mvm_clip`` regresses. The vq target classifies ``size_vq`` dVAE
    tokens: with ``vq_on_the_fly`` the model holds the dVAE (``dvae``) and
    predicts each ``vq_patch`` cell from ``decoder_vq``'s shuffled output,
    else the step is given pre-extracted tokens.
    """

    special_token_ids = (101, 102, 0)     # [CLS], [SEP], [PAD] of bert-base
    mask_token_id = 103
    num_options = 4                       # VTM: 1 positive + 3 in-batch negatives
    mvm_targets_ported = ("pixel", "2d_feature", "3d_feature", "2d_clip", "hog", "vq",
                          "depth", "optical_flow")

    def __init__(self, config: ModelConfig, *, mvm_target=("pixel",),
                 pretrain_tasks=("mtm", "vtm", "mvm"), pretrain_masks=("bm", "rm"),
                 p_mask: float = 0.15, temp: float = 0.05,
                 clip_arch=(768, 12, 12, 3072), size_vq: int = 8192, vq_patch: int = 8,
                 vq_on_the_fly: bool = False, dtype=torch.float32, device="cuda",
                 seed: int = 0):
        if not set(mvm_target) <= set(self.mvm_targets_ported):
            raise NotImplementedError(f"mvm_target {tuple(mvm_target)}: only "
                                      f"{self.mvm_targets_ported} are ported")
        if "vq" in mvm_target and {"3d_feature", "2d_feature"} & set(mvm_target):
            raise ValueError("the vq and feature targets would both name their head fc_mvm")
        if not set(pretrain_tasks) <= {"mtm", "vtm", "mvm", "smtm"}:
            raise ValueError(f"unknown pretrain_tasks {tuple(pretrain_tasks)}")
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
            if "hog" in mvm_target:
                self.decoder_hog = Linear(d, ps * ps, compute_dtype=dtype)
            if "optical_flow" in mvm_target:
                self.decoder_flow = Linear(2 * d, ps * ps * 2, compute_dtype=dtype)
                self.raft = RAFT(dtype=dtype)
                self.raft.requires_grad_(False)
            if "depth" in mvm_target:
                self.decoder_depth = Linear(d, ps * ps, compute_dtype=dtype)
                self.dpt = DPTDepth(dtype=dtype)
                self.dpt.requires_grad_(False)
            if "vq" in mvm_target:
                if vq_on_the_fly:
                    # conv1x1 D -> 2D + PixelShuffle(up): 2D / up^2 channels a cell
                    up = ps // vq_patch
                    self.decoder_vq = Linear(d, 2 * d, compute_dtype=dtype)
                    self.fc_mvm = ScoreHead(2 * d // (up * up), size_vq, dtype)
                    self.dvae = DvaeEncoder(dtype=dtype)
                    self.dvae.requires_grad_(False)
                else:
                    self.fc_mvm = ScoreHead(d, size_vq, dtype)
            if {"3d_feature", "2d_feature"} & set(mvm_target):
                teacher = (SwinConfig.base() if "3d_feature" in mvm_target
                           else swin2d_config("base"))
                self.fc_mvm = ScoreHead(d, teacher.num_features, dtype)
                self.feature_model = SwinTransformer3D(teacher, dtype, fused_norms=True)
                self.feature_model.requires_grad_(False)
            if "2d_clip" in mvm_target:
                self.fc_mvm_clip = ScoreHead(d, clip_arch[0], dtype)
                self.clip_model = CLIPVisual(*clip_arch, image_size=config.size_img,
                                             dtype=dtype)
                self.clip_model.requires_grad_(False)
        self.mvm_target = tuple(mvm_target)
        self.pretrain_tasks = tuple(pretrain_tasks)
        self.pretrain_masks = tuple(pretrain_masks)
        self.p_mask, self.temp = p_mask, temp
        self.vq_patch, self.vq_on_the_fly = vq_patch, vq_on_the_fly
        init_weights(self, torch.Generator(device).manual_seed(seed))

    @classmethod
    def from_run_config(cls, run: RunConfig, **kwargs) -> "VioletPretrain":
        """The model a pretrain task file (``configs/pretrain.json``) names."""
        t = run.train
        return cls(run.model, mvm_target=t.mvm_target, pretrain_tasks=t.pretrain_tasks,
                   pretrain_masks=t.pretrain_masks, p_mask=t.p_mask, temp=t.temp,
                   clip_arch=t.clip_arch, vq_on_the_fly=run.model.vq_on_the_fly, **kwargs)

    def patch_tokens(self, out_mvm, t, h, w):
        """Drop the per-frame CLS, return the (B, T, h, w, D) grid
        (ref: main_pretrain.py:391,425)."""
        b, _, d = out_mvm.shape
        return out_mvm.reshape(b, t, 1 + h * w, d)[:, :, 1:].reshape(b, t, h, w, d)

    def decode_pixel(self, grid):
        return pixel_shuffle_tokens(self.decoder_pixel(grid), self.config.size_patch, 3)

    def decode_hog(self, grid):
        return pixel_shuffle_tokens(self.decoder_hog(grid), self.config.size_patch, 1)[..., 0]

    def decode_depth(self, grid):
        return pixel_shuffle_tokens(self.decoder_depth(grid), self.config.size_patch, 1)[..., 0]

    def decode_flow(self, grid):
        """Adjacent frames' tokens side by side, decoded to the 2-channel
        flow of each pair (ref: main_pretrain.py:391-399)."""
        pair = torch.cat([grid[:, :-1], grid[:, 1:]], dim=-1)
        return pixel_shuffle_tokens(self.decoder_flow(pair), self.config.size_patch, 2)

    def decode_vq_logits(self, grid):
        """(ref: main_pretrain.py:492-500): 1x1 conv to 2D channels, shuffled
        to the dVAE cell grid, classified ``size_vq`` ways (the score head's
        dropout off, as the JAX package calls it)."""
        up = self.config.size_patch // self.vq_patch
        x = self.decoder_vq(grid)
        return self.fc_mvm(pixel_shuffle_tokens(x, up, x.shape[-1] // (up * up)))

    def vq_answers(self, img, mvm_mask, vq=None):
        """The on-the-fly vq answers (B, T, H/8, W/8): the dVAE's token of
        each frame's cell (``vq``, when given, in its place) where the pixel
        cover touches the cell (its 8 x 8 max-pool), else -1
        (ref: main_pretrain.py:480-491)."""
        b, t, hh, ww = img.shape[:4]
        if vq is None:
            with torch.no_grad(), tracing.span("pretrain.teacher"):
                vq = self.dvae.extract_vq_tokens(img.reshape(b * t, hh, ww, 3))
        p = self.vq_patch
        cells = mvm_mask[..., 0].reshape(b, t, hh // p, p, ww // p, p).amax(dim=(3, 5))
        return torch.where(cells > 0, vq.reshape(cells.shape), -1)

    def flow_loss(self, img, grid, mvm_mask):
        """RAFT's flow of each adjacent frame pair (under no_grad) against the
        decoded flow, masked L1 over the pixels either frame covers, pairs
        whose flow reaches 50 pixels left out (ref: main_pretrain.py:386-419)."""
        b, t, hh, ww = img.shape[:4]
        with torch.no_grad(), tracing.span("pretrain.teacher"):
            target = self.raft(img[:, :-1].reshape(-1, hh, ww, 3),
                               img[:, 1:].reshape(-1, hh, ww, 3)).reshape(b, t - 1, hh, ww, 2)
        keep = target.abs().amax(dim=(2, 3, 4)) < 50.0                      # (B, T-1)
        cover = mvm_mask[:, :-1] + mvm_mask[:, 1:]
        return masked_l1(self.decode_flow(grid), target,
                         (cover > 0) & keep[:, :, None, None, None], channel_div=2.0)

    @torch.no_grad()
    def get_att(self, img, txt, mask) -> torch.Tensor:
        """The attention rollout of ``am`` masking (JAX ``get_att``; ref:
        main_pretrain.py:211-215): the deterministic pass over ``img`` (no
        dropout, drop path or batch statistics), the fusion under the full
        joint mask with every layer's probabilities out
        (``BertEncoder(output_attentions=True)``), each layer's mean over
        heads summed over layers and queries: (B, Lv + X) fp32."""
        fi, mi, ft, mt = self.go_feat(img, txt, mask)
        feat = torch.cat([fi.to(self.dtype), ft.to(self.dtype)], dim=1)
        _, probs = self.trsfr(feat, joint_attn_bias(mi, mt), output_attentions=True)
        return sum(p.mean(dim=1).sum(dim=1) for p in probs)

    def forward(self, img, txt, mask, neg_idx=None, generator=None):
        """One pretrain forward (ref: main_pretrain.py:226-267) on a masked
        batch. ``neg_idx`` (B, O-1) names each row's negative captions (rows
        of the global batch); with O = min(global B, num_options) > 1 it is
        required. Returns the MTM logits,
        the fused video tokens, the VTM logits (positive first) and, with
        the ``smtm`` task, the MLM logits of a second fusion of the same
        features under the seq2seq mask (``out_smtm``)."""
        b, t = img.shape[:2]
        h = w = img.shape[2] // self.config.size_patch
        o = min(global_rows(b), self.num_options)
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        if o > 1:
            if neg_idx is None or neg_idx.shape != (b, o - 1):
                raise ValueError(f"neg_idx must be ({b}, {o - 1})")
            flat = neg_idx.reshape(-1)
            all_out = self.go_cross(
                torch.cat([fi, fi.repeat_interleave(o - 1, 0)]),
                torch.cat([mi, mi.repeat_interleave(o - 1, 0)]),
                torch.cat([ft, gather_rows(ft)[flat]]),
                torch.cat([mt, gather_rows(mt)[flat]]), generator)
            out, p_out = all_out[:b], all_out[b:]
        else:
            out, p_out = self.go_cross(fi, mi, ft, mt, generator), None
        lv = fi.shape[1]                  # t * (1 + h * w), one frame under mean fusion
        out_mvm, out_txt = out[:, :lv], out[:, lv:]
        out_vtm = self.fc(out[:, lv], generator)                     # (B, 1)
        if p_out is not None:
            neg = self.fc(p_out[:, lv], generator).reshape(b, o - 1)
            out_vtm = torch.cat([out_vtm, neg], dim=1)
        res = {"out_mtm": self.fc_mtm(out_txt), "out_mvm": out_mvm, "out_vtm": out_vtm}
        if "smtm" in self.pretrain_tasks:
            s_out = self.go_cross(fi, mi, ft, mt, generator, "seq2seq")
            res["out_smtm"] = self.fc_mtm(s_out[:, lv:])
        return res

    def losses(self, img, txt, mask, *, generator=None, mask_generator=None,
               draws: MaskDraws | None = None, neg_idx=None, hog=None, vq=None,
               corrupt=None) -> dict:
        """Masking, forward and every loss of one pretrain step
        (ref: main_pretrain.py:276-372, 374-553, 555-569).

        ``img`` is the unmasked clip, uint8 or normalized float. Masks and
        negatives are drawn from ``mask_generator`` unless ``draws`` and
        ``neg_idx`` are given; ``generator`` drives dropout and stochastic
        depth (None: the deterministic pass). ``hog`` (B, T, H, W), when
        given, is the hog target in place of :func:`hog_image` of the clip
        (the JAX ``losses(hog=...)``). ``vq`` is the vq target's tokens: the
        pre-extracted (B, T*(1+h*w)) of the JAX ``losses(vq=...)``, or with
        ``vq_on_the_fly`` the dVAE's (B, T, H/8, W/8) in place of the
        teacher's own, as ``hog`` is. ``corrupt`` (B,) bool zeroes those
        clips after normalization (the reference's normalized-space zeros,
        ref: main_pretrain.py:94-117) and, where the hog target is computed
        here, leaves them out of the hog loss, as the JAX ``losses`` does.
        """
        img = maybe_normalize(img)
        if corrupt is not None:
            img = torch.where(corrupt.bool()[:, None, None, None, None],
                              torch.zeros((), dtype=img.dtype, device=img.device), img)
        b, t = img.shape[:2]
        ps = self.config.size_patch
        h, w = img.shape[2] // ps, img.shape[3] // ps
        vq_tokens = None if self.vq_on_the_fly else vq
        o = min(global_rows(b), self.num_options)
        with tracing.span("pretrain.masking"):
            if draws is None:
                # am: one more no-grad pass over the unmasked batch (ref: :321-323)
                scores = self.get_att(img, txt, mask) if "am" in self.pretrain_masks else None
                draws = draw_masks(mask_generator, txt, t, h, w,
                                   special_token_ids=self.special_token_ids,
                                   mask_token_id=self.mask_token_id, p_mask=self.p_mask,
                                   mask_types=self.pretrain_masks, att_scores=scores,
                                   vq=vq_tokens)
            mb = apply_masking(draws, img, txt, vq_tokens, mask_token_id=self.mask_token_id,
                               patch_size=ps)
            if neg_idx is None and o > 1:
                neg_idx = local_rows(draw_negatives(mask_generator, global_rows(b), o - 1))
        out = self(mb.img, mb.txt, mask, neg_idx, generator)
        ls = {"mtm": cross_entropy_ignore(out["out_mtm"], mb.ans_mtm),
              "vtm": cross_entropy_ignore(out["out_vtm"] / self.temp,
                                          torch.zeros(b, dtype=torch.int64,
                                                      device=img.device))}
        if "out_smtm" in out:
            ls["smtm"] = cross_entropy_ignore(out["out_smtm"], mb.ans_mtm)
        if "mvm" in self.pretrain_tasks:
            grid = self.patch_tokens(out["out_mvm"], t, h, w)
            cov = mb.cov[..., None]
            if "pixel" in self.mvm_target:
                ls["mvm_pixel"] = masked_l1(self.decode_pixel(grid), img, mb.mvm_mask,
                                            channel_div=3.0)
            if "hog" in self.mvm_target:
                hog_mask = mb.mvm_mask[..., 0]
                if hog is None:
                    with torch.no_grad():
                        hog = hog_image(img)
                    if corrupt is not None:
                        hog_mask = torch.where(corrupt.bool()[:, None, None, None],
                                               torch.zeros((), dtype=hog_mask.dtype,
                                                           device=hog_mask.device), hog_mask)
                ls["mvm_hog"] = masked_l1(self.decode_hog(grid), hog, hog_mask)
            if "vq" in self.mvm_target and self.vq_on_the_fly:
                ls["mvm_vq"] = cross_entropy_ignore(self.decode_vq_logits(grid),
                                                    self.vq_answers(img, mb.mvm_mask, vq))
            elif "vq" in self.mvm_target:
                ls["mvm_vq"] = cross_entropy_ignore(self.fc_mvm(out["out_mvm"], generator),
                                                    mb.ans_mvm)
            if "depth" in self.mvm_target:
                # the reference's /3 channel quirk (main_pretrain.py:433-452
                # divides by _in_C though depth has one channel)
                with torch.no_grad(), tracing.span("pretrain.teacher"):
                    target = self.dpt(img.reshape(b * t, *img.shape[2:]))
                ls["mvm_depth"] = masked_l1(self.decode_depth(grid),
                                            target.reshape(b, t, *target.shape[1:]),
                                            mb.mvm_mask[..., 0], channel_div=3.0)
            if "optical_flow" in self.mvm_target and t > 1:
                ls["mvm_flow"] = self.flow_loss(img, grid, mb.mvm_mask)
            if {"3d_feature", "2d_feature"} & set(self.mvm_target):
                with torch.no_grad(), tracing.span("pretrain.teacher"):  # unmasked clip
                    target = self.feature_model(img)
                for name in ("3d_feature", "2d_feature"):
                    if name in self.mvm_target:
                        ls[f"mvm_{name}"] = masked_l1(self.fc_mvm(grid, generator), target,
                                                      cov, channel_div=3.0)
            if "2d_clip" in self.mvm_target:
                with torch.no_grad(), tracing.span("pretrain.teacher"):  # CLIP-normalized
                    frames = renormalize_imagenet_to_clip(img.reshape(b * t, *img.shape[2:]))
                    target = self.clip_model.features(frames)
                ls["mvm_2d_clip"] = masked_l1(self.fc_mvm_clip(grid, generator),
                                              target.reshape(b, t, *target.shape[1:]), cov,
                                              channel_div=3.0)
        ls["total"] = sum(ls.values())
        return ls
