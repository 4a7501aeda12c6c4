"""2D image encoders (counterpart of ``empirical_mvm_tpu/models/encoders2d.py``).

Only the 2D Swin geometry is ported so far: :func:`swin2d_config` builds the
:class:`SwinConfig` under which the port's 3D ``SwinTransformer3D`` computes
a per-frame 2D Swin (HF ``microsoft/swin-{size}-patch4-window7-224``), the
frozen feature teacher of the ``2d_feature`` MVM target. The trained 2D
encoders (``EncImgSwin``, ResNet, MERLOT) are not ported yet.
"""

from __future__ import annotations

from empirical_mvm_torch.core.config import SwinConfig

SWIN2D_SIZES = {
    # (embed_dim, depths, num_heads) for microsoft/swin-{size}-patch4-window7-224
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
    "large": (192, (2, 2, 18, 2), (6, 12, 24, 48)),
}


def swin2d_config(size: str) -> SwinConfig:
    """Patch (1, 4, 4) and window (1, 7, 7): a 2D Swin run frame by frame.
    ``final_norm=False``: the reference consumes HF ``hidden_states[-1]``,
    the last stage's output before ``SwinModel``'s final LayerNorm
    (ref: visbackbone/swin.py:75-77, main_pretrain.py:537)."""
    dim, depths, heads = SWIN2D_SIZES[size]
    return SwinConfig(patch_size=(1, 4, 4), embed_dim=dim, depths=depths,
                      num_heads=heads, window_size=(1, 7, 7), final_norm=False)
