"""The plain reference of the VIOLET-base models the benchmark runs: the Video
Swin, the BERT embeddings and fusion, the pretrain heads (each MVM target's head
and teacher from its file under ``targets/``), and the retrieval head.

Plain PyTorch in float32 (the caller turns TF32 off), no kernels, no cache,
no batching tricks. The semantics follow ``empirical_mvm_torch`` as of
commit affdfaf9 (``models/video_swin.py``, ``models/bert.py``,
``models/violet.py``, ``models/pretrain.py``, ``models/tasks.py``,
``ops/patch_embed.py``), written out again here, so a later change to the
program cannot move the yardstick. Parameter names are the program's
``state_dict`` names, so one seeded weight set loads into both.

Every random draw of a training pass (stochastic depth, hidden dropout,
the attention dropout's Philox seeds, the mask and negative draws) is made
from the generator the step hands in, in the program's order and at the
program's shapes, so the reference drops and masks what the program does.
The attention dropout's keep mask is regenerated from the (seed, offset)
pair with Philox4x32-10 in integer tensor ops (``philox.py``).

``Numerics`` rounds the operands of every matrix product: float32 leaves
them alone; ``fp8`` is the recipe of float8 training, the control of the
correctness check: the operands rounded to float8 e4m3 and the gradient
arriving at each product's output to float8 e5m2, each with a per-tensor
scale.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import targets
from portbench.reference.philox import dropout_keep

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
F32_MIN = torch.finfo(torch.float32).min


def fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8) under the per-tensor scale
    that maps its largest magnitude to the format's largest value."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _GradToE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Numerics:
    """Rounding of a matrix product's operands (``__call__``) and of the
    gradient at its output (``grad``): ``fp32`` rounds nothing; ``fp8``
    rounds the operands to e4m3 (the rounding passed straight through to
    the gradient) and the output's gradient to e5m2."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        xd = x.detach()
        return x + (fp8_round(xd, torch.float8_e4m3fn) - xd)

    def grad(self, y: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32" or not y.requires_grad:
            return y
        return _GradToE5M2.apply(y)


FP32 = Numerics("fp32")


# --------------------------------------------------------------------- pieces

def dropout(x, p, generator):
    """Inverted dropout drawn from ``generator``; none without one."""
    if generator is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def drop_path(x, rate, generator):
    """Stochastic depth: each sample's branch kept with probability 1 - rate."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, x.new_zeros(()))


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=True, num: Numerics = FP32):
        super().__init__()
        self.num = num
        self.weight = nn.Parameter(torch.zeros(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None

    def forward(self, x):
        return self.num.grad(F.linear(self.num(x), self.num(self.weight), self.bias))


class LayerNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        xc = x - mean
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + self.eps) * self.weight + self.bias


def attend(q, k, v, adds, scale, num: Numerics, keep=None, p_drop=0.0):
    """softmax(q k^T * scale + sum(adds)), dropped under ``keep``, times v."""
    s = num.grad(torch.matmul(num(q * scale), num(k).transpose(-1, -2)))
    for a in adds:
        s = s + a
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = torch.where(keep, p * (1.0 / (1.0 - p_drop)), 0.0)
    return num.grad(torch.matmul(num(p), num(v)))


# ----------------------------------------------------------------- video swin

def get_window_size(x_size, window_size, shift_size):
    use_window, use_shift = list(window_size), list(shift_size)
    for i, xs in enumerate(x_size):
        if xs <= window_size[i]:
            use_window[i] = xs
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def relative_position_index(window_size):
    """(N, N) index into the bias table for the full window."""
    wd, wh, ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)


def shift_attn_mask(dims, window_size, shift_size):
    """(nW, N, N) additive mask of the shifted windows, -100 across regions."""
    dp, hp, wp = dims
    img_mask = np.zeros((1, dp, hp, wp, 1), dtype=np.float32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(1, dp // wd, wd, hp // wh, wh, wp // ww, ww, 1)
    m = m.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    return np.where(m[:, None, :] - m[:, :, None] != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x, window):
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, c)


def window_reverse(win, window, b, d, h, w):
    wd, wh, ww = window
    x = win.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


class WindowAttention3D(nn.Module):
    def __init__(self, dim, window_size, num_heads, num):
        super().__init__()
        self.window_size, self.num_heads, self.num = tuple(window_size), num_heads, num
        self.scale = (dim // num_heads) ** -0.5
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.index = torch.from_numpy(relative_position_index(self.window_size))
        self.qkv = Linear(dim, 3 * dim, num=num)
        self.proj = Linear(dim, dim, num=num)

    def forward(self, x, mask, window):
        b, d, h, w, c = x.shape
        n = window[0] * window[1] * window[2]
        nh = self.num_heads
        idx = self.index[:n, :n].reshape(-1).to(x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh).permute(2, 0, 1)
        qkv = window_partition(self.qkv(x), window)                # (B_, N, 3C)
        b_ = qkv.shape[0]
        q, k, v = qkv.reshape(b_, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        adds = [bias[None]]
        if mask is not None:
            nw = mask.shape[0]
            adds.append(mask[None, :, None].expand(b_ // nw, nw, nh, n, n).reshape(b_, nh, n, n))
        o = attend(q, k, v, adds, self.scale, self.num)
        o = o.transpose(1, 2).reshape(b_, n, c)
        return self.proj(window_reverse(o, window, b, d, h, w))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, num):
        super().__init__()
        self.fc1 = Linear(dim, hidden, num=num)
        self.fc2 = Linear(hidden, dim, num=num)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, rate, num):
        super().__init__()
        self.window_size, self.shift_size, self.rate = tuple(window), tuple(shift), rate
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention3D(dim, window, heads, num)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, num)

    def forward(self, x, attn_mask, generator):
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size, self.shift_size)
        shortcut = x
        x = F.pad(self.norm1(x), (0, 0, 0, (-w) % window[2], 0, (-h) % window[1],
                                  0, (-d) % window[0]))
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        x = self.attn(x, attn_mask if shifted else None, window)
        if shifted:
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        x = shortcut + drop_path(x[:, :d, :h, :w], self.rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim, num):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, num=num)

    def forward(self, x):
        x = F.pad(x, (0, 0, 0, x.shape[3] % 2, 0, x.shape[2] % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, window, downsample, rates, num):
        super().__init__()
        self.window_size = tuple(window)
        half = tuple(s // 2 for s in self.window_size)
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, (0, 0, 0) if i % 2 == 0 else half, rates[i], num)
            for i in range(depth)])
        self.downsample = PatchMerging(dim, num) if downsample else None

    def forward(self, x, generator):
        b, d, h, w, c = x.shape
        window, shift = get_window_size((d, h, w), self.window_size,
                                        tuple(s // 2 for s in self.window_size))
        dims = tuple(-(-s // ws) * ws for s, ws in zip((d, h, w), window))
        mask = torch.from_numpy(shift_attn_mask(dims, window, shift)).to(x.device)
        for blk in self.blocks:
            x = blk(x, mask, generator)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed3D(nn.Module):
    """Conv3d(kernel (kd, 4, 4), stride (1, 4, 4)) over the clip padded by
    kd - 1 frames at its end, so the output keeps T frames."""

    def __init__(self, patch, dim, num):
        super().__init__()
        self.patch, self.num = tuple(patch), num
        self.proj = nn.Conv3d(3, dim, kernel_size=self.patch, stride=(1, *self.patch[1:]))
        self.norm = LayerNorm(dim)

    def forward(self, x):
        kd, kh, kw = self.patch
        x = x.permute(0, 4, 1, 2, 3)                               # (B, 3, T, H, W)
        x = F.pad(x, (0, (-x.shape[4]) % kw, 0, (-x.shape[3]) % kh, 0, kd - 1))
        y = self.num.grad(F.conv3d(self.num(x), self.num(self.proj.weight), self.proj.bias,
                                   stride=(1, kh, kw)))
        return self.norm(y.permute(0, 2, 3, 4, 1))


class SwinTransformer3D(nn.Module):
    """``swin``: a dict of patch_size, embed_dim, depths, num_heads,
    window_size, drop_path_rate, final_norm."""

    def __init__(self, swin: dict, num: Numerics = FP32):
        super().__init__()
        self.patch_embed = PatchEmbed3D(swin["patch_size"], swin["embed_dim"], num)
        depths = swin["depths"]
        dpr = np.linspace(0, swin["drop_path_rate"], sum(depths)).tolist()
        starts = np.cumsum((0,) + tuple(depths)).tolist()
        self.layers = nn.ModuleList([
            BasicLayer(swin["embed_dim"] * 2 ** i, depth, swin["num_heads"][i],
                       swin["window_size"], i < len(depths) - 1,
                       dpr[starts[i]:starts[i] + depth], num)
            for i, depth in enumerate(depths)])
        self.num_features = swin["embed_dim"] * 2 ** (len(depths) - 1)
        self.norm = LayerNorm(self.num_features) if swin["final_norm"] else None

    def forward(self, x, generator=None):
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x, generator)
        return x if self.norm is None else self.norm(x)


# ----------------------------------------------------------------------- bert

def extended_attention_mask(mask):
    """(B, L) 0/1 -> additive (B, 1, 1, L): 0 where allowed, float32 min."""
    return (1.0 - mask[:, None, None, :].float()) * F32_MIN


class BertEmbeddings(nn.Module):
    def __init__(self, bert: dict):
        super().__init__()
        d = bert["hidden_size"]
        self.p_drop = bert["hidden_dropout_prob"]
        self.word_embeddings = nn.Embedding(bert["vocab_size"], d)
        self.position_embeddings = nn.Embedding(bert["max_position_embeddings"], d)
        self.token_type_embeddings = nn.Embedding(bert["type_vocab_size"], d)
        self.LayerNorm = LayerNorm(d, bert["layer_norm_eps"])

    def forward(self, ids, generator=None):
        ids = ids.long()
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(ids)))
        return dropout(self.LayerNorm(x), self.p_drop, generator)


class _Output(nn.Module):
    def __init__(self, d_in, d, eps, p_drop, num):
        super().__init__()
        self.p_drop = p_drop
        self.dense = Linear(d_in, d, num=num)
        self.LayerNorm = LayerNorm(d, eps)

    def forward(self, h, residual, generator):
        return self.LayerNorm(dropout(self.dense(h), self.p_drop, generator) + residual)


class BertSelfAttention(nn.Module):
    def __init__(self, bert, num):
        super().__init__()
        d = bert["hidden_size"]
        self.num_heads, self.p_attn, self.num = bert["num_attention_heads"], \
            bert["attention_probs_dropout_prob"], num
        self.self = nn.Module()
        for name in ("query", "key", "value"):
            setattr(self.self, name, Linear(d, d, num=num))
        self.output = _Output(d, d, bert["layer_norm_eps"], bert["hidden_dropout_prob"], num)

    def forward(self, x, mask, generator):
        b, l, d = x.shape
        nh = self.num_heads
        q, k, v = (getattr(self.self, n)(x).reshape(b, l, nh, d // nh).transpose(1, 2)
                   for n in ("query", "key", "value"))
        keep, p = None, 0.0
        if generator is not None and self.p_attn > 0.0:
            p = self.p_attn
            seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                                 generator=generator, device=generator.device)
            keep = dropout_keep(seed, (b, nh, l, l), p)
        ctx = attend(q, k, v, [mask[:, None]], (d // nh) ** -0.5, self.num, keep, p)
        return self.output(ctx.transpose(1, 2).reshape(b, l, d), x, generator)


class BertLayer(nn.Module):
    def __init__(self, bert, num):
        super().__init__()
        self.attention = BertSelfAttention(bert, num)
        self.intermediate = nn.Module()
        self.intermediate.dense = Linear(bert["hidden_size"], bert["intermediate_size"], num=num)
        self.output = _Output(bert["intermediate_size"], bert["hidden_size"],
                              bert["layer_norm_eps"], bert["hidden_dropout_prob"], num)

    def forward(self, x, mask, generator):
        x = self.attention(x, mask, generator)
        return self.output(F.gelu(self.intermediate.dense(x)), x, generator)


class BertEncoder(nn.Module):
    def __init__(self, bert, num):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(bert, num)
                                    for _ in range(bert["num_hidden_layers"])])

    def forward(self, x, attn_bias, generator=None):
        b, l = x.shape[:2]
        mask = attn_bias.reshape(b, 1, l).expand(b, l, l)
        for layer in self.layer:
            x = layer(x, mask, generator)
        return x


class BertMLMHead(nn.Module):
    def __init__(self, bert, num):
        super().__init__()
        d = bert["hidden_size"]
        self.predictions = nn.Module()
        self.predictions.transform = nn.Module()
        self.predictions.transform.dense = Linear(d, d, num=num)
        self.predictions.transform.LayerNorm = LayerNorm(d, bert["layer_norm_eps"])
        self.predictions.decoder = Linear(d, bert["vocab_size"], num=num)

    def forward(self, x):
        t = self.predictions.transform
        return self.predictions.decoder(t.LayerNorm(F.gelu(t.dense(x))))


class ScoreHead(nn.Sequential):
    """dropout(0.1) -> Linear(D, 2D) -> ReLU -> Linear(2D, out); names fc.1, fc.3."""

    def __init__(self, d, out, num):
        super().__init__(nn.Identity(), Linear(d, 2 * d, num=num), nn.ReLU(),
                         Linear(2 * d, out, num=num))

    def forward(self, x, generator=None):
        return self.score_terms(x, generator)[0]

    def score_terms(self, x, generator=None):
        """The output and, for a one-output head, the norm of the terms
        w_i relu(h)_i its last product sums (the scale rounding works on)."""
        h = torch.relu(self[1](dropout(x, 0.1, generator)))
        out = self[3](h)
        scale = (h * self[3].weight[0]).norm(dim=-1) if self[3].weight.shape[0] == 1 else None
        return out, scale


# --------------------------------------------------------------------- violet

def normalize(img):
    """uint8 (..., 3) -> ImageNet-normalized float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img.float() / 255.0 - mean) / std


class EncVideo(nn.Module):
    def __init__(self, cfg: dict, num):
        super().__init__()
        d = cfg["fusion"]["hidden_size"]
        self.swin = SwinTransformer3D(cfg["swin"], num)
        self.latent = self.swin.num_features
        self.fc = Linear(self.latent, d, num=num)
        self.emb_cls = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.emb_pos = nn.Parameter(torch.zeros(1, 1, 1 + cfg["max_size_patch"] ** 2, d))
        self.emb_len = nn.Parameter(torch.zeros(1, cfg["max_size_frame"], 1, d))
        self.emb_odr = nn.Parameter(torch.zeros(1, 1, 1, d))
        self.norm = LayerNorm(d, 1e-5)

    def forward(self, img, generator=None):
        if img.dtype == torch.uint8:
            img = normalize(img)
        b, t, hh, ww, _ = img.shape
        hw = (hh // 32) * (ww // 32)
        f = self.fc(self.swin(img, generator).reshape(b, t, hw, self.latent))
        f = torch.cat([self.emb_cls.expand(b, t, 1, f.shape[-1]), f], dim=2)
        f = self.norm(f + self.emb_pos[:, :, :1 + hw] + self.emb_len[:, :t])
        m = torch.ones((b, t * (1 + hw)), dtype=torch.int32, device=f.device)
        return f.reshape(b, t * (1 + hw), -1), m


class EncTxt(nn.Module):
    def __init__(self, cfg, num):
        super().__init__()
        self.emb_txt = BertEmbeddings(cfg["text"])

    def forward(self, txt, generator=None):
        return self.emb_txt(txt, generator)


class VioletBase(nn.Module):
    """``cfg``: the model part of a configuration file (see ``model_dims``)."""

    def __init__(self, cfg: dict, num: Numerics = FP32):
        super().__init__()
        self.cfg, self.num = cfg, num
        self.enc_img = EncVideo(cfg, num)
        self.enc_txt = EncTxt(cfg, num)
        self.trsfr = BertEncoder(cfg["fusion"], num)

    def go_feat(self, img, txt, mask, generator=None):
        fi, mi = self.enc_img(img, generator)
        return fi, mi, self.enc_txt(txt, generator), mask

    def go_cross(self, fi, mi, ft, mt, generator=None):
        bias = extended_attention_mask(torch.cat([mi, mt], dim=1))
        return self.trsfr(torch.cat([fi, ft], dim=1), bias, generator)


class VioletPretrain(VioletBase):
    """VTM + MTM + MVM. Each MVM target of ``mvm_target`` brings its head and
    its frozen teacher, if it has one, from its file under ``targets/``,
    which registers them under the program's state-dict names."""

    num_options = 4

    def __init__(self, cfg, num: Numerics, mvm_target):
        super().__init__(cfg, num)
        d = cfg["fusion"]["hidden_size"]
        self.fc = ScoreHead(d, 1, num)
        self.fc_mtm = BertMLMHead(cfg["fusion"], num)
        self.targets = targets.ordered(mvm_target)
        for target in self.targets:
            target.build(self, cfg, num)
        self.frozen_prefixes = tuple(p for target in self.targets for p in target.FROZEN)
        self.weight_rules = targets.weight_rules(self.targets)

    def frozen(self, name: str) -> bool:
        """A teacher's parameter, which no step moves."""
        return name.startswith(self.frozen_prefixes)

    def forward(self, img, txt, mask, neg_idx, generator=None):
        b = img.shape[0]
        o = min(b, self.num_options)
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        flat = neg_idx.reshape(-1)
        out = self.go_cross(torch.cat([fi, fi.repeat_interleave(o - 1, 0)]),
                            torch.cat([mi, mi.repeat_interleave(o - 1, 0)]),
                            torch.cat([ft, ft[flat]]), torch.cat([mt, mt[flat]]), generator)
        out, p_out = out[:b], out[b:]
        lv = fi.shape[1]
        pos, pos_scale = self.fc.score_terms(out[:, lv], generator)
        neg, neg_scale = self.fc.score_terms(p_out[:, lv], generator)
        vtm = torch.cat([pos, neg.reshape(b, o - 1)], dim=1)
        return {"out_mtm": self.fc_mtm(out[:, lv:]), "out_mvm": out[:, :lv], "out_vtm": vtm,
                "vtm_scores": torch.cat([pos.reshape(-1), neg.reshape(-1)]).detach(),
                "vtm_scales": torch.cat([pos_scale, neg_scale]).detach()}


class VioletRetrieval(VioletBase):
    def __init__(self, cfg, num: Numerics = FP32):
        super().__init__(cfg, num)
        self.fc = ScoreHead(cfg["fusion"]["hidden_size"], 1, num)

    def encode_video(self, img):
        """(B, Clips, T, H, W, 3) -> clip-mean video tokens and the first clip's mask."""
        b, clips = img.shape[:2]
        fi, mi = self.enc_img(img.reshape(-1, *img.shape[2:]))
        return fi.reshape(b, clips, -1, fi.shape[-1]).mean(dim=1), mi.reshape(b, clips, -1)[:, 0]

    def score_terms(self, fi, mi, ft, mt):
        """The scores and the norms of the terms their last product sums."""
        out, scale = self.fc.score_terms(self.go_cross(fi, mi, ft, mt)[:, fi.shape[1]])
        return out[..., 0], scale

