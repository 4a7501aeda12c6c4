"""The ``pixel`` MVM target: the clip's normalized pixels decoded from the
fused video tokens by ``decoder_pixel``, masked L1 over the pixel cover
(the program's ``models/pretrain.py`` ``decode_pixel``). No teacher."""

from portbench.reference.model import Linear
from portbench.reference.steps import masked_l1

LOSS_ORDER = 10
FROZEN = ()
teacher_call = None


def build(model, dims, num):
    ps = dims["size_patch"]
    model.decoder_pixel = Linear(dims["fusion"]["hidden_size"], ps * ps * 3, num=num)


def decode(model, grid):
    """(B, T, h, w, D) -> (B, T, h ps, w ps, 3): each token's ps x ps x 3
    outputs laid out channel-major, as torch's PixelShuffle does."""
    b, t, h, w, _ = grid.shape
    r = model.cfg["size_patch"]
    x = model.decoder_pixel(grid).reshape(b, t, h, w, 3, r, r).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h * r, w * r, 3)


def losses(model, mvm):
    return {"mvm_pixel": masked_l1(decode(model, mvm.grid), mvm.img, mvm.pix, channel_div=3.0)}


def flops(dims, run, batch, count):
    """The decoder over every patch token."""
    ps = dims["size_patch"]
    rows = batch * run["size_frame"] * (run["size_img"] // ps) ** 2
    return 2.0 * rows * dims["fusion"]["hidden_size"] * ps * ps * 3, 0.0
