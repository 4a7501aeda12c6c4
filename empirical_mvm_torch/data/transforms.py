"""Temporal sampling and the spatial transforms of a clip, split into a plan
drawn on the host and an executor that runs it on a device (counterpart of
``empirical_mvm_tpu/data/transforms.py``; ref: dataset.py:91-195,
visbackbone/video_transform.py, eval_retrieval.py:18-43).

The JAX package decodes each frame with cv2 in the loader's threads and
transforms it there. Here the host only plans: the frame picks
(:func:`sampling`, :func:`temporal_sample`, :func:`multi_clip_indices`),
the eval downgrade (:func:`eval_transform`), and each frame's pad, resize
size and crop box (:func:`plan_clip`), drawn from the item's
``random.Random`` in the JAX package's order of draws. A frame's size comes
from its JPEG header (``data/jpeg.py`` ``jpeg_size``), so the plan needs no
decode. :func:`run_plans` then takes the decoded uint8 HWC frames on any
device and pads, resizes (bilinear with half-pixel centres and no
antialias, as cv2 ``INTER_LINEAR``; rounded to uint8, so within one step of
cv2's fixed-point result) and crops them there, and returns uint8
(B, T, H, W, 3) channel-last clips, or ImageNet-normalized float32 where
the plan asks for it.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

import torch
import torch.nn.functional as F

from empirical_mvm_torch.ops.preprocess import normalize_uint8

TRANSFORMS = ("pad_resize", "img_center_crop", "vid_center_crop", "img_rand_crop",
              "vid_rand_crop")


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """One frame's ops: zero-pad the (h, w) frame by ``pad`` (top, bottom,
    left, right), resize it to ``size`` (h, w), crop ``crop`` (top, left,
    h, w) of that."""
    src: tuple[int, int]
    pad: tuple[int, int, int, int]
    size: tuple[int, int]
    crop: tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class ClipPlan:
    """A clip's compressed frames, in clip order, and each frame's ops.
    With no frames the clip is zeros of ``shape`` (T, H, W) (the JAX
    ``zero_clip``). ``normalize``: ImageNet-normalized float32 out, else
    uint8. ``failed_frames``: the T of the zero clip that replaces this one
    if a frame fails to decode (the JAX ``zero_clip``'s ``size_frame``; 0:
    this clip's T)."""
    frames: tuple[bytes, ...]
    ops: tuple[FramePlan, ...]
    shape: tuple[int, int, int]
    normalize: bool
    failed_frames: int = 0

    def zeroed(self) -> "ClipPlan":
        """Zeros of this clip's shape (the JAX ``np.zeros_like(img)``)."""
        return dataclasses.replace(self, frames=(), ops=())

    def failed(self) -> "ClipPlan":
        """The zero clip that takes this one's place when a frame fails."""
        t = self.failed_frames or self.shape[0]
        return dataclasses.replace(self, frames=(), ops=(), shape=(t, *self.shape[1:]))


def sampling(start: int, end: int, n: int) -> list[int]:
    """Evenly spaced rounded indices (ref: dataset.py:142-146)."""
    if n == 1:
        return [int(round((start + end) / 2.0))]
    step = (end - start) / float(n - 1)
    return [int(round(start + x * step)) for x in range(n)]


def temporal_sample(n_avail: int, size_frame: int, random_clip: bool,
                    rng: random.Random) -> list[int]:
    """Frame indices for one clip (ref: dataset.py:148-163)."""
    if n_avail == 1 or n_avail == size_frame:
        return list(range(n_avail))
    sf = min(size_frame, n_avail)
    size_clips = int(math.ceil(n_avail / sf))
    if random_clip:
        start = rng.randrange(size_clips)
        end = min(start + (sf - 1) * size_clips, n_avail - 1)
    else:
        start, end = 0, n_avail - 1
    return sampling(start, end, sf)


def multi_clip_indices(n_avail: int, size_frame: int) -> list[list[int]]:
    """All temporal crops for multi-clip retrieval eval
    (ref: eval_retrieval.py:28-36)."""
    if n_avail == 1 or n_avail == size_frame:
        return [list(range(n_avail))]
    sf = min(size_frame, n_avail)
    size_clips = int(math.ceil(n_avail / sf))
    clips = []
    for start in range(size_clips):
        end = min(start + (sf - 1) * size_clips, n_avail - 1)
        clips.append(sampling(start, end, sf))
    return clips


def eval_transform(transform: str, split: str) -> str:
    """Eval-time transform downgrades (ref: dataset.py:179-189)."""
    if split == "train":
        return transform
    return {"vid_rand_crop": "vid_center_crop",
            "img_rand_crop": "img_center_crop"}.get(transform, transform)


def resize_size(h: int, w: int, size: int) -> tuple[int, int]:
    """The JAX ``_resize(short_side=True)`` target: the short side scaled to
    ``size`` (torchvision ``Resize(int)``)."""
    if h < w:
        return size, max(1, int(round(w * size / h)))
    return max(1, int(round(h * size / w))), size


def _crop_box(h: int, w: int, size: int) -> tuple[int, int, int, int]:
    """The box numpy's ``img[top:top + size, left:left + size]`` keeps."""
    return 0, 0, min(size, h), min(size, w)


def plan_frame(kind: str, h: int, w: int, size: int, rng: random.Random) -> FramePlan:
    """One frame's ops for transform ``kind``, with the JAX
    ``apply_transform``'s draws (ref: dataset.py:91-134)."""
    if kind == "pad_resize":
        pad = ((w - h) // 2, w - h - (w - h) // 2, 0, 0) if w > h else \
            (0, 0, (h - w) // 2, h - w - (h - w) // 2) if h > w else (0, 0, 0, 0)
        return FramePlan((h, w), pad, (size, size), (0, 0, size, size))
    nh, nw = resize_size(h, w, size)
    if kind in ("img_center_crop", "vid_center_crop"):
        top, left = (nh - size) // 2, (nw - size) // 2
    elif kind in ("img_rand_crop", "vid_rand_crop"):
        top = rng.randint(0, nh - size) if nh > size else 0
        left = rng.randint(0, nw - size) if nw > size else 0
    else:
        raise ValueError(f"unknown transform {kind}")
    _, _, ch, cw = _crop_box(nh - top, nw - left, size)
    return FramePlan((h, w), (0, 0, 0, 0), (nh, nw), (top, left, ch, cw))


def plan_clip(frames: Sequence[bytes], sizes: Sequence[tuple[int, int]], size_img: int,
              split: str, transform: str, rng: random.Random,
              normalize: bool) -> ClipPlan:
    """The plan of the JAX ``clip_from_images`` for frames of ``sizes``
    (h, w): ``vid_rand_crop`` resizes every frame by its short side and
    crops them all with one window drawn from the first; the other
    transforms plan each frame on its own, in order."""
    transform = eval_transform(transform, split)
    if transform == "vid_rand_crop":
        shapes = [resize_size(h, w, size_img) for h, w in sizes]
        h, w = shapes[0]
        top = rng.randint(0, h - size_img) if h > size_img else 0
        left = rng.randint(0, w - size_img) if w > size_img else 0
        ops = tuple(FramePlan(src, (0, 0, 0, 0), (nh, nw),
                              (top, left) + _crop_box(nh - top, nw - left, size_img)[2:])
                    for src, (nh, nw) in zip(sizes, shapes))
    else:
        ops = tuple(plan_frame(transform, h, w, size_img, rng) for h, w in sizes)
    return ClipPlan(tuple(frames), ops, (len(ops), size_img, size_img), normalize)


def zero_plan(size_frame: int, size_img: int, normalize: bool) -> ClipPlan:
    """The JAX ``zero_clip``: zeros of (size_frame, size_img, size_img, 3)."""
    return ClipPlan((), (), (size_frame, size_img, size_img), normalize)


def resize_uint8(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> (N, h, w, 3), bilinear with half-pixel centres
    and no antialias (cv2 ``INTER_LINEAR``), rounded to the nearest uint8."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=size, mode="bilinear",
                      align_corners=False, antialias=False)
    return y.round_().clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def _frame_pixels(frames: list[torch.Tensor], ops: list[FramePlan]) -> list[torch.Tensor]:
    """Pad, resize and crop every frame; frames that share their source
    size, pad and resize size are resized in one call."""
    groups: dict[tuple, list[int]] = {}
    for i, op in enumerate(ops):
        groups.setdefault((op.src, op.pad, op.size), []).append(i)
    out: list[torch.Tensor | None] = [None] * len(ops)
    for (src, pad, size), idx in groups.items():
        x = torch.stack([frames[i] for i in idx])
        if any(pad):
            top, bottom, left, right = pad
            x = F.pad(x, (0, 0, left, right, top, bottom))
        x = resize_uint8(x, size)
        for j, i in enumerate(idx):
            top, left, ch, cw = ops[i].crop
            out[i] = x[j, top:top + ch, left:left + cw]
    return out


def run_plans(plans: Sequence[ClipPlan], frames: Sequence[Sequence[torch.Tensor]],
              device) -> torch.Tensor:
    """Execute ``plans`` on ``device``: ``frames[i]`` are plan i's decoded
    uint8 (h, w, 3) frames on that device (none for a zero clip). Returns
    the stacked clips (B, T, H, W, 3), uint8, or float32 ImageNet-normalized
    where the plans ask for it (every plan of a batch asks the same)."""
    normalize = {p.normalize for p in plans}
    if len(normalize) != 1:
        raise ValueError("the clips of a batch must all be normalized or all uint8")
    flat_frames, flat_ops = [], []
    for i, (plan, fr) in enumerate(zip(plans, frames)):
        if len(fr) != len(plan.ops):
            raise ValueError(f"clip {i}: {len(fr)} decoded frames for {len(plan.ops)} planned")
        flat_frames.extend(fr)
        flat_ops.extend(plan.ops)
    pixels = _frame_pixels(flat_frames, flat_ops) if flat_ops else []
    clips = []
    k = 0
    for plan in plans:
        t, h, w = plan.shape
        if plan.ops:
            clip = torch.stack(pixels[k:k + len(plan.ops)])
            k += len(plan.ops)
        else:
            clip = torch.zeros((t, h, w, 3), dtype=torch.uint8, device=device)
        clips.append(clip)
    out = torch.stack(clips)
    if normalize.pop():
        zero = torch.tensor([not p.ops for p in plans], device=device)
        out = torch.where(zero[:, None, None, None, None], 0.0, normalize_uint8(out))
    return out
