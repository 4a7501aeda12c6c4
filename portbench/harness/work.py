"""The work a cell asks of the model, counted from its shapes: matrix-product
FLOPs of the Video Swin, the BERT fusion, the heads and each MVM target's
head and teacher (counted in its file under ``reference/targets/``), and
the operations and bytes of each attention call, from which the rooflines
take their least time.

Conventions: a multiply-add is 2 FLOPs; a trained part costs 3x its
forward (forward, and the backward's two products), a frozen teacher its
forward alone; recomputation is not counted. An attention call's least
time is max(ops / peak FLOP/s, bytes / peak bytes/s), its backward taking
2.5x the forward's ops, every input read once and every output written
once (bf16 activations, fp32 bias and mask).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass


@dataclass(frozen=True)
class Call:
    """One attention call: its FLOPs and the bytes it must move."""
    ops: float
    nbytes: float


def _clamp(x_size, window):
    return tuple(min(x, w) for x, w in zip(x_size, window))


def swin_stages(swin: dict, t: int, h: int, w: int):
    """Per stage: (tokens of one clip, width, heads, window tokens N,
    windows of one clip, shifted blocks, unshifted blocks, merges)."""
    kd, kh, kw = swin["patch_size"]
    hh, ww = -(-h // kh), -(-w // kw)
    out = []
    for i, depth in enumerate(swin["depths"]):
        c = swin["embed_dim"] * 2 ** i
        win = _clamp((t, hh, ww), swin["window_size"])
        dims = tuple(-(-x // s) * s for x, s in zip((t, hh, ww), win))
        n = win[0] * win[1] * win[2]
        nw = (dims[0] // win[0]) * (dims[1] // win[1]) * (dims[2] // win[2])
        shift = any(s // 2 > 0 and x > s for s, x in zip(swin["window_size"], (t, hh, ww)))
        shifted = depth // 2 if shift else 0
        out.append(dict(tokens=t * hh * ww, c=c, heads=swin["num_heads"][i], n=n, nw=nw,
                        padded=dims[0] * dims[1] * dims[2], shifted=shifted,
                        unshifted=depth - shifted, merge=i < len(swin["depths"]) - 1))
        if i < len(swin["depths"]) - 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
    return out


def swin_forward_flops(swin: dict, t: int, h: int, w: int) -> float:
    """Matrix-product FLOPs of one clip's forward through a Swin."""
    kd, kh, kw = swin["patch_size"]
    tok0 = t * -(-h // kh) * -(-w // kw)
    total = 2.0 * tok0 * kd * kh * kw * 3 * swin["embed_dim"]
    for s in swin_stages(swin, t, h, w):
        tok, c, blocks = s["tokens"], s["c"], s["shifted"] + s["unshifted"]
        # qkv 6C^2, proj 2C^2, MLP 16C^2 a token; QK^T and PV 4 N C a token
        total += blocks * (24.0 * tok * c * c + 4.0 * s["padded"] * s["n"] * c)
        if s["merge"]:
            total += 4.0 * tok * c * c
    return total


def bert_layer_flops(length: int, d: int, ffn: int) -> float:
    """One BERT layer over one row of ``length`` tokens."""
    return 2.0 * length * (4 * d * d + 2 * d * ffn) + 4.0 * length * length * d


def fusion_forward_flops(bert: dict, rows: int, length: int) -> float:
    return rows * bert["num_hidden_layers"] * bert_layer_flops(
        length, bert["hidden_size"], bert["intermediate_size"])


def score_head_flops(d: int, out: int, rows: int) -> float:
    return 2.0 * rows * (d * 2 * d + 2 * d * out)


def video_tokens(dims: dict, t: int, size: int) -> int:
    hw = (size // dims["size_patch"]) ** 2
    return t * (1 + hw)


def video_fc_flops(dims: dict, t: int, size: int) -> float:
    """The Video Swin's latent projected to the fusion width, one clip."""
    hw = (size // dims["size_patch"]) ** 2
    latent = dims["swin"]["embed_dim"] * 2 ** (len(dims["swin"]["depths"]) - 1)
    return 2.0 * t * hw * latent * dims["fusion"]["hidden_size"]


def pretrain_step_flops(dims: dict, run: dict, batch: int, options: int = 4) -> float:
    """One pretrain step of the run configuration ``run``: the fusion over
    ``options`` rows a clip (VTM's positive and ``options`` - 1 negatives)
    with the VTM and MTM heads, which the program computes whatever
    ``pretrain_tasks`` says, and with the ``mvm`` task what each target of
    ``mvm_target`` counts in its file under ``reference/targets/``: its head
    (trained) and its frozen teacher's forward. The trained parts count 3x,
    the teacher 1x. Any other task, or a target with no file, is refused,
    not left out."""
    from portbench.reference import targets
    tasks = set(run["pretrain_tasks"])
    if not tasks <= {"vtm", "mtm", "mvm"}:
        raise ValueError(f"pretrain_tasks {sorted(tasks)}: the FLOP count covers vtm, mtm "
                         "and mvm")
    mvm = targets.ordered(run["mvm_target"]) if "mvm" in tasks else []
    t, size, x = run["size_frame"], run["size_img"], run["size_txt"]
    f, d = dims["fusion"], dims["fusion"]["hidden_size"]
    lv = video_tokens(dims, t, size)
    trained = batch * (swin_forward_flops(dims["swin"], t, size, size)
                       + video_fc_flops(dims, t, size))
    o = min(batch, options)
    trained += fusion_forward_flops(f, batch * o, lv + x)
    trained += score_head_flops(d, 1, batch * o)                             # VTM
    trained += batch * x * 2.0 * (d * d + d * f["vocab_size"])               # MTM head
    teacher = 0.0
    for target in mvm:
        head, frozen = target.flops(dims, run, batch, sys.modules[__name__])
        trained += head
        teacher += frozen
    return 3.0 * trained + teacher


def retrieval_eval_flops(dims: dict, clips: int, pairs: int, t: int, size: int,
                         x: int) -> float:
    """One two-stage eval: ``clips`` clips encoded, ``pairs`` pairs fused."""
    d = dims["fusion"]["hidden_size"]
    lv = video_tokens(dims, t, size)
    enc = clips * (swin_forward_flops(dims["swin"], t, size, size) + video_fc_flops(dims, t, size))
    return enc + fusion_forward_flops(dims["fusion"], pairs, lv + x) + score_head_flops(d, 1, pairs)


def window_attention_calls(swin: dict, clips: int, t: int, size: int,
                           backward: bool) -> list[Call]:
    """Every window-attention call of ``clips`` clips through a Swin: one a
    block, forward and, with ``backward``, its backward."""
    calls = []
    for s in swin_stages(swin, t, size, size):
        c, nh, n = s["c"], s["heads"], s["n"]
        tok = clips * s["padded"]
        ops = 4.0 * clips * s["nw"] * n * n * c
        bias = nh * n * n * 4.0
        mask = s["nw"] * n * n * 4.0
        for shifted, count in ((True, s["shifted"]), (False, s["unshifted"])):
            extra = mask if shifted else 0.0
            for _ in range(count):
                calls.append(Call(ops, tok * 4 * c * 2.0 + bias + extra))
                if backward:
                    calls.append(Call(2.5 * ops, tok * 7 * c * 2.0 + 2 * bias + extra))
    return calls


def self_attention_calls(bert: dict, rows: int, length: int, backward: bool) -> list[Call]:
    """Every fusion self-attention call over ``rows`` rows of ``length``
    tokens (a padding row of fp32 per row)."""
    d = bert["hidden_size"]
    ops = 4.0 * rows * length * length * d
    mask = rows * length * 4.0
    calls = []
    for _ in range(bert["num_hidden_layers"]):
        calls.append(Call(ops, rows * length * 4 * d * 2.0 + mask))
        if backward:
            calls.append(Call(2.5 * ops, rows * length * 7 * d * 2.0 + mask))
    return calls


def least_seconds(calls, peak_flops: float, peak_bytes: float) -> float:
    return sum(max(c.ops / peak_flops, c.nbytes / peak_bytes) for c in calls)
