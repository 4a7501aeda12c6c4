"""Retrieval task model, forward only (counterpart of
``VioletRetrieval`` in ``empirical_mvm_tpu/models/tasks.py``)."""

from __future__ import annotations

import torch

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.common import init_weights
from empirical_mvm_torch.models.violet import ScoreHead, VioletBase


def _cls_pos(img_shape, size_patch: int) -> int:
    """Index of the first text token in the fused sequence
    (ref: main_retrieval.py:81)."""
    t, hh = img_shape[1], img_shape[2]
    return t * (1 + (hh // size_patch) ** 2)


class VioletRetrieval(VioletBase):
    """(ref: main_retrieval.py:57-85, eval_retrieval.py:96-115)

    Built on ``device`` (the card unless the caller asks for the CPU) with
    parameters drawn from ``seed``; load a converted checkpoint with
    ``load_state_dict`` to replace them.
    """

    def __init__(self, config: ModelConfig, dtype=torch.float32,
                 device="cuda", seed: int = 0):
        device = torch.device(device)
        with device:
            super().__init__(config, dtype)
            self.fc = ScoreHead(config.hidden_size, dtype=dtype)
        init_weights(self, torch.Generator(device).manual_seed(seed))
        self.eval()

    def forward(self, img, txt, mask):
        """All-pairs scores (B, B): row i is video i against every caption."""
        b = img.shape[0]
        cls_pos = _cls_pos(img.shape, self.config.size_patch)
        fi, mi, ft, mt = self.go_feat(img, txt, mask)
        out = self.go_cross(fi.repeat_interleave(b, 0), mi.repeat_interleave(b, 0),
                            torch.cat([ft] * b), torch.cat([mt] * b))
        return self.fc(out[:, cls_pos]).reshape(b, b)

    def encode(self, img, txt, mask):
        """Stage-1 features of the two-stage eval. ``img`` is (B, Clips, T, H,
        W, 3), whose clips are mean-pooled with the mask of the first clip,
        or (B, T, H, W, 3) (ref: eval_retrieval.py:100-110)."""
        if img.ndim == 6:
            b, clips = img.shape[:2]
            fi, mi = self.enc_img(img.reshape(-1, *img.shape[2:]))
            fi = fi.reshape(b, clips, -1, fi.shape[-1]).mean(dim=1)
            mi = mi.reshape(b, clips, -1)[:, 0]
        else:
            fi, mi = self.enc_img(img)
        return fi, mi, self.enc_txt(txt), mask

    def score_pairs(self, feat_img, mask_img, feat_txt, mask_txt):
        """Stage-2 cross scores of prepared (text, video) rows, read at the
        first text token (ref: eval_retrieval.py:112-115)."""
        out = self.go_cross(feat_img, mask_img, feat_txt, mask_txt)
        return self.fc(out[:, feat_img.shape[1]])[..., 0]
