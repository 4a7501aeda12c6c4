"""The ``2d_feature`` MVM target: a frozen 2D Swin teacher's features of the
unmasked clip, regressed through ``fc_mvm`` from the fused video tokens,
masked L1 over the patch cover (the program's ``models/pretrain.py``:
``fc_mvm``, ``feature_model``; ref: main_pretrain.py:508-545)."""

import torch

from portbench.reference.model import ScoreHead, SwinTransformer3D
from portbench.reference.steps import masked_l1

LOSS_ORDER = 60
FROZEN = ("feature_model.",)


def _width(dims) -> int:
    return dims["teacher"]["embed_dim"] * 2 ** (len(dims["teacher"]["depths"]) - 1)


def build(model, dims, num):
    model.fc_mvm = ScoreHead(dims["fusion"]["hidden_size"], _width(dims), num)
    model.feature_model = SwinTransformer3D(dims["teacher"], num)
    model.feature_model.requires_grad_(False)


def losses(model, mvm):
    with torch.no_grad():
        target = model.feature_model(mvm.img)
    return {"mvm_2d_feature": masked_l1(model.fc_mvm(mvm.grid, mvm.drop_gen), target,
                                        mvm.cov[..., None], channel_div=3.0)}


def flops(dims, run, batch, count):
    """The head over every patch token; the teacher's forward over the clips."""
    t, size = run["size_frame"], run["size_img"]
    rows = batch * t * (size // dims["size_patch"]) ** 2
    return (count.score_head_flops(dims["fusion"]["hidden_size"], _width(dims), rows),
            batch * count.swin_forward_flops(dims["teacher"], t, size, size))


def teacher_call(model, img):
    return model.feature_model(img)
