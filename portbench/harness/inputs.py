"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, by parameter name and shape, and the traffic's batches and eval
items. Everything is drawn on the device with ``torch.Generator``s in a few
large calls; the same seed gives the same values.

Weights: LayerNorm weights 1, biases 0, every other parameter N(0, 0.02),
drawn as one flat buffer over the parameters in sorted name order, so that
two models with the same names and shapes get the same values whatever
order they hold them in. The names alone decide which is which. An MVM
target's weight rules (``reference/targets/``) replace that for the names
they match: a fixed value, or the same draw scaled to another std; the
other parameters keep their values bit for bit.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

STD = 0.02
_NORM = re.compile(r"(^|\.)(norm\d*|LayerNorm)\.weight$")


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed of one stream of ``seed`` (weights, traffic, sample)."""
    words = np.random.SeedSequence([seed, purpose]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def weight_kind(name: str) -> str:
    if _NORM.search(name):
        return "one"
    if name.endswith("bias"):
        return "zero"
    return "normal"


def make_weights(specs: dict[str, tuple[int, ...]], seed: int, device,
                 rules=()) -> dict[str, torch.Tensor]:
    """fp32 weights for ``specs`` (name -> shape): views into one buffer.
    The first of ``rules`` (``targets.Rule``) whose pattern a name matches
    replaces that name's default."""
    names = sorted(specs)
    sizes = [int(np.prod(specs[n])) for n in names]
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, STD, generator=gen)
    out, off = {}, 0
    for name, size in zip(names, sizes):
        view = flat[off:off + size].view(specs[name])
        rule = next((r for r in rules if re.search(r.pattern, name)), None)
        kind = weight_kind(name)
        if rule is not None:
            _apply(rule, name, view)
        elif kind != "normal":
            view.fill_(1.0 if kind == "one" else 0.0)
        out[name] = view
        off += size
    return out


def _apply(rule, name: str, view: torch.Tensor) -> None:
    if rule.kind == "value":
        view.fill_(rule.number)
    elif rule.kind == "std":
        view.mul_(rule.number / STD)
    elif rule.kind == "fan_in" and view.dim() >= 2:
        view.mul_(rule.number / math.sqrt(view[0].numel()) / STD)
    else:
        raise ValueError(f"weight rule {rule} on {name} {tuple(view.shape)}: kind is value, "
                         "std, or fan_in on a weight of two or more dimensions")


def param_specs(model) -> dict[str, tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


@torch.no_grad()
def load_weights(model, weights: dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"weights and model differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        p.copy_(weights[name])


def captions(gen, n: int, size_txt: int, vocab: int, device, shortest: int = 6):
    """``n`` captions of ``shortest`` to ``size_txt`` tokens: [CLS], ids
    drawn from 1000 up to the vocabulary, [SEP], zero padding; and their
    mask. int32 (n, size_txt) each."""
    lengths = torch.randint(shortest, size_txt + 1, (n, 1), generator=gen, device=device)
    ids = torch.randint(1000, vocab, (n, size_txt), generator=gen, device=device)
    pos = torch.arange(size_txt, device=device)[None]
    txt = torch.where(pos < lengths, ids, 0)
    txt[:, 0] = 101
    txt.scatter_(1, lengths - 1, 102)
    txt = txt.to(torch.int32)
    return txt, (txt > 0).to(torch.int32)


def clips(gen, shape, device) -> torch.Tensor:
    """uint8 clips of ``shape`` (..., T, H, W, 3)."""
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)


def train_pool(seed: int, count: int, batch: int, frames: int, size: int, size_txt: int,
               vocab: int, device) -> list[dict]:
    """``count`` batches of ``batch`` clips and captions, every row distinct."""
    gen = torch.Generator(device).manual_seed(stream_seed(seed, 2))
    img = clips(gen, (count, batch, frames, size, size, 3), device)
    txt, mask = captions(gen, count * batch, size_txt, vocab, device)
    txt, mask = txt.view(count, batch, -1), mask.view(count, batch, -1)
    return [{"img": img[i], "txt": txt[i], "mask": mask[i]} for i in range(count)]


class RetrievalItems:
    """``n`` captions, each with its own video of ``n_clips`` clips, held in
    host memory as numpy uint8 as a loader would hand them over: the
    ``multi_clip_item`` interface of the program's retrieval dataset.
    Video ids are zero-padded so that their sorted order is their index."""

    def __init__(self, seed: int, n: int, n_clips: int, frames: int, size: int,
                 size_txt: int, vocab: int, device):
        gen = torch.Generator(device).manual_seed(stream_seed(seed, 3))
        self.img = clips(gen, (n, n_clips, frames, size, size, 3), device)
        self.txt, self.mask = captions(gen, n, size_txt, vocab, device)
        img, txt, mask = self.img.cpu().numpy(), self.txt.cpu().numpy(), self.mask.cpu().numpy()
        self.items = [{"img": img[i], "txt": txt[i], "mask": mask[i], "vid": f"v{i:06d}",
                       "tid": i} for i in range(n)]
        self.gt_txt2vid = {i: f"v{i:06d}" for i in range(n)}

    def __len__(self):
        return len(self.items)

    def multi_clip_item(self, i):
        return self.items[i]
