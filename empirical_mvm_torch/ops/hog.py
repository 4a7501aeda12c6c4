"""HOG target extraction for MVM-HOG (counterpart of
``empirical_mvm_tpu/ops/hog.py``).

skimage's HOG visualization as torch ops on the clip's device, the JAX
package's algorithm step for step: central-difference gradients (zero at
the borders), per pixel the channel of largest magnitude (the first on a
tie, one-hot selected), the unsigned orientation ``atan2(g_row, g_col) %
pi`` in 9 bins clipped to [0, 8], per 8 x 8 cell the mean magnitude of each
bin, and the rendered image: each cell's histogram times a (9, 8, 8) stencil
of Bresenham lines through the cell centre (``_line_templates``, numpy, a
copy of the JAX package's). It is no Pallas kernel in the JAX package and
has no hand-written kernel here.

A pixel whose angle lies within rounding of a bin edge may fall in the
other bin on another device or library (``atan2`` and the division differ
in the last bit); :func:`hog_bins` exposes the bins so that a caller can
count such pixels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _line_templates(cell: int = 8, orientations: int = 9) -> np.ndarray:
    """(O, cell, cell) float templates: the rendered line for each
    orientation bin, as drawn by skimage's hog visualization (a Bresenham
    line of radius cell//2 - 1 through the cell center, angle at the bin
    midpoint)."""
    radius = cell // 2 - 1
    centre = (cell // 2, cell // 2)
    out = np.zeros((orientations, cell, cell), np.float32)
    for o in range(orientations):
        angle = (o + 0.5) * np.pi / orientations
        dr = np.sin(angle) * radius
        dc = np.cos(angle) * radius
        r0, c0 = int(centre[0] - dc), int(centre[1] + dr)
        r1, c1 = int(centre[0] + dc), int(centre[1] - dr)
        # Bresenham (skimage.draw.line semantics): iterate over the major axis
        steep = abs(r1 - r0) > abs(c1 - c0)
        x0, y0, x1, y1 = ((r0, c0, r1, c1) if steep else (c0, r0, c1, r1))
        if x0 > x1:
            x0, x1, y0, y1 = x1, x0, y1, y0
        dx, dy = x1 - x0, abs(y1 - y0)
        err = dx / 2.0
        ystep = 1 if y0 < y1 else -1
        y = y0
        for x in range(x0, x1 + 1):
            rr, cc = (x, y) if steep else (y, x)
            if 0 <= rr < cell and 0 <= cc < cell:
                out[o, rr, cc] = 1.0
            err -= dy
            if err < 0:
                y += ystep
                err += dx
    return out


def hog_bins(img: torch.Tensor, orientations: int = 9):
    """Per pixel of (..., H, W, C) float images: the orientation bin
    (int64, in [0, orientations)) and the gradient magnitude (fp32) of the
    dominant channel."""
    x = img.float()
    g_row = torch.zeros_like(x)
    g_row[..., 1:-1, :, :] = x[..., 2:, :, :] - x[..., :-2, :, :]
    g_col = torch.zeros_like(x)
    g_col[..., :, 1:-1, :] = x[..., :, 2:, :] - x[..., :, :-2, :]
    mag = torch.hypot(g_row, g_col)                        # (..., H, W, C)
    sel = F.one_hot(mag.argmax(-1), img.shape[-1]).float()
    g_row = (g_row * sel).sum(-1)
    g_col = (g_col * sel).sum(-1)
    mag = (mag * sel).sum(-1)
    ang = torch.remainder(torch.atan2(g_row, g_col), math.pi)
    bins = (ang / (math.pi / orientations)).to(torch.int32).clamp(0, orientations - 1)
    return bins.long(), mag


def hog_image(img: torch.Tensor, *, cell: int = 8, orientations: int = 9) -> torch.Tensor:
    """Dense HOG visualization target.

    Args:
      img: (..., H, W, C) float image (any channel count; the dominant
        channel per pixel is used, like skimage's channel_axis handling).
    Returns:
      (..., H, W) float32 HOG image.
    """
    h, w = img.shape[-3], img.shape[-2]
    if h % cell or w % cell:
        raise ValueError(f"image {h} x {w} is not a whole number of {cell} x {cell} cells")
    bins, mag = hog_bins(img, orientations)
    weighted = F.one_hot(bins, orientations).float() * mag[..., None]   # (..., H, W, O)
    ch, cw = h // cell, w // cell
    lead = weighted.shape[:-3]
    weighted = weighted.reshape(*lead, ch, cell, cw, cell, orientations)
    hist = weighted.sum(dim=(-4, -2)) / (cell * cell)               # (..., ch, cw, O)
    templ = torch.from_numpy(_line_templates(cell, orientations)).to(img.device)
    cells = torch.einsum("...rco,oij->...rcij", hist, templ)
    nd = len(lead)
    out = cells.permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)     # (..., ch, i, cw, j)
    return out.reshape(*lead, h, w)
