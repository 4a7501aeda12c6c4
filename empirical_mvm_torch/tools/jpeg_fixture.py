"""The committed JPEG fixture: eight 256 x 340 frames and cv2's decode of
them, the reference that the card's nvJPEG decode is held to.

The frames are smooth random fields, as the JAX ``tools/loaderbench.py``
makes them (uniform noise blurred with sigma 9), each from its own seed,
encoded by cv2 at quality 87 (4:2:0, cv2's default). ``main`` writes them
with cv2 (only where cv2 is installed); :func:`load_fixture` reads them
with numpy alone, where no JPEG library is installed.

The stored decode is cv2's RGB output, delta-coded along each row and then
down each column (uint8, wrapping) so that zlib packs it. Two decoders of
one JPEG may differ in their IDCT (cv2's libjpeg-turbo runs the integer
``ISLOW`` one) and in how they upsample the 4:2:0 chroma. ``main`` measures the second on these
frames: the cv2 decode's chroma, cut to 2 x 2 means and brought back by
replication and by the triangular filter libjpeg-turbo uses, differs by
``chroma_spread_max`` at most and ``chroma_spread_mean`` on average. The
limits of a decode against this reference (``limit_max_abs``,
``limit_mean_abs``) are those plus the IDCT's rounding: one step in the
luma and in each chroma plane, which the colour conversion carries into
RGB as at most 1 + 1.772 steps (``IDCT_STEPS_MAX``: blue takes 1.772 Cb)
and 0.5 on average. On the H100 nvJPEG read 4 steps at most against a
limit of 5, and 0.46-0.50 on average against 0.634.

    python -m empirical_mvm_torch.tools.jpeg_fixture
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent.parent / "assets" / "jpeg_fixture.npz"
FRAMES, HEIGHT, WIDTH, QUALITY, SIGMA = 8, 256, 340, 87, 9
IDCT_STEPS_MAX, IDCT_STEPS_MEAN = 1 + 1.772, 0.5


def load_fixture(path: Path = FIXTURE) -> dict:
    """{"frames": [jpeg bytes], "decode": uint8 (8, 256, 340, 3) RGB,
    "limit_max_abs", "limit_mean_abs", ...}."""
    with np.load(path) as z:
        data = z["jpeg"]
        ends = z["jpeg_ends"]
        starts = np.concatenate([[0], ends[:-1]])
        out = {"frames": [data[s:e].tobytes() for s, e in zip(starts, ends)],
               "decode": np.cumsum(np.cumsum(z["decode_delta"], axis=1, dtype=np.uint8),
                                   axis=2, dtype=np.uint8)}
        for k in ("chroma_spread_max", "chroma_spread_mean"):
            out[k] = float(z[k])
    out["limit_max_abs"] = float(math.ceil(out["chroma_spread_max"] + IDCT_STEPS_MAX))
    out["limit_mean_abs"] = out["chroma_spread_mean"] + IDCT_STEPS_MEAN
    return out


def _ycc(rgb):
    r, g, b = (rgb[..., i] for i in range(3))
    return (0.299 * r + 0.587 * g + 0.114 * b,
            128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b)


def _rgb(y, cb, cr):
    return np.stack([y + 1.402 * (cr - 128),
                     y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
                     y + 1.772 * (cb - 128)], -1)


def _fancy_up(c):
    """2x upsampling with the triangular (3/4, 1/4) filter, edges clamped."""
    def up(a, axis):
        n = a.shape[axis]
        prev = np.take(a, np.clip(np.arange(n) - 1, 0, n - 1), axis=axis)
        nxt = np.take(a, np.clip(np.arange(n) + 1, 0, n - 1), axis=axis)
        even, odd = 0.75 * a + 0.25 * prev, 0.75 * a + 0.25 * nxt
        return np.stack([even, odd], axis=axis + 1).reshape(
            a.shape[:axis] + (2 * n,) + a.shape[axis + 1:])
    return up(up(c, 0), 1)


def chroma_spread(rgb: np.ndarray) -> tuple[float, float]:
    """Largest and mean |difference| between replicated and triangular
    upsampling of the frame's 2 x 2-averaged chroma, in RGB steps."""
    y, cb, cr = _ycc(rgb.astype(np.float64))
    h, w = y.shape

    def down(c):
        return c[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    near = [np.repeat(np.repeat(down(c), 2, 0), 2, 1) for c in (cb, cr)]
    fancy = [_fancy_up(down(c)) for c in (cb, cr)]
    yy = y[:h // 2 * 2, :w // 2 * 2]
    d = np.abs(_rgb(yy, *near) - _rgb(yy, *fancy))
    return float(d.max()), float(d.mean())


def make(path: Path = FIXTURE) -> dict:
    import cv2
    jpegs, decodes = [], []
    for i in range(FRAMES):
        rs = np.random.RandomState(i)
        base = cv2.GaussianBlur((rs.rand(HEIGHT, WIDTH, 3) * 255).astype(np.uint8),
                                (0, 0), SIGMA)
        ok, buf = cv2.imencode(".jpg", base, [cv2.IMWRITE_JPEG_QUALITY, QUALITY])
        assert ok
        jpegs.append(buf.tobytes())
        decodes.append(cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1])
    dec = np.stack(decodes)
    spreads = [chroma_spread(d) for d in dec]
    spread_max = max(s for s, _ in spreads)
    spread_mean = float(np.mean([m for _, m in spreads]))
    data = np.frombuffer(b"".join(jpegs), np.uint8)
    np.savez_compressed(
        path, jpeg=data, jpeg_ends=np.cumsum([len(j) for j in jpegs]),
        decode_delta=np.diff(np.diff(dec, axis=2, prepend=np.zeros_like(dec[:, :, :1])),
                             axis=1, prepend=np.zeros_like(dec[:, :1])),
        chroma_spread_max=spread_max, chroma_spread_mean=spread_mean)
    return {"bytes": path.stat().st_size, "jpeg_bytes": int(data.size),
            "chroma_spread_max": spread_max, "chroma_spread_mean": spread_mean}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    args = ap.parse_args(argv)
    print(make(args.out))


if __name__ == "__main__":
    main()
