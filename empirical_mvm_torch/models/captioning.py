"""Video captioning (counterpart of ``empirical_mvm_tpu/models/captioning.py``):
the seq2seq-masked MLM training pass and three autoregressive decoders
(ref: model_for_captioning.py:35-310, main_caption.py:56-68).

* Training: :meth:`VioletCaptioning.forward` fuses [video ; corrupted caption]
  under the ``seq2seq`` joint mask (video rows see video, text rows video
  and the text at or before them) and returns the MLM logits of the text
  positions, which ``label_smoothed_nll`` scores against the corrupted
  positions.
* :meth:`~VioletCaptioning.generate` re-encodes the whole caption at every
  position (the [MASK]-append trick: [MASK] at position i, the logits read
  there): one fusion pass a position, through the fusion's kernels.
* :meth:`~VioletCaptioning.generate_cached` (JAX's default decoder for the
  embeddings-only text encoder; it refuses a text stack, as JAX does) runs the
  fusion layers once over the video, keeps each layer's video K/V, and then
  runs one two-token step a position ([the token at i-1, [MASK] at i])
  against that cache and the text K/V committed so far. As in JAX this is
  plain tensor code (matmuls, softmax, the LayerNorm's plain version) on
  the fusion modules' own weights, not the fusion's kernels; its greedy
  tokens equal the re-encoding decoder's. It saves FLOPs but launches many
  small operations a layer and position, so at the caption config (batch
  8, max_len 20) it is host-bound and slower than :meth:`generate` on an
  H100 (PERF.md); it is kept as JAX's API and as the reference the
  re-encoding decoder is held against.
* :meth:`~VioletCaptioning.generate_beam` runs the k hypotheses of every
  clip through one fusion pass a position.

The decoders are fixed-shape loops over positions 1 .. max_len-1, like the
JAX ``lax.scan``: every position runs, a finished caption emits [PAD], and
nothing waits on the host. Sampling draws from an explicit generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from empirical_mvm_torch.core.config import ModelConfig
from empirical_mvm_torch.models.bert import BertMLMHead
from empirical_mvm_torch.models.tasks import _Task, draw_gumbel
from empirical_mvm_torch.ops.layernorm import layer_norm_reference


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 0.0,
                  temperature: float = 1.0) -> torch.Tensor:
    """(B, V) logits in fp32 divided by ``temperature``, -inf below the k-th
    largest (``top_k`` > 0) and below the smallest of the fewest largest
    whose probabilities reach ``top_p`` (> 0) (ref:
    model_for_captioning.py:169-198 top_k_top_p_filtering; JAX ``_sample``)."""
    logits = logits.float() / temperature
    if top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if top_p > 0.0:
        sorted_l = logits.sort(dim=-1, descending=True).values
        cum = sorted_l.softmax(dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        logits = logits.masked_fill(logits < sorted_l.gather(-1, cutoff_idx), -math.inf)
    return logits


def sample_next(logits: torch.Tensor, decode: str = "greedy", top_k: int = 0,
                top_p: float = 0.0, temperature: float = 1.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Next token of each row of (B, V) logits: the argmax for ``greedy``,
    else a draw from the categorical over :func:`filter_logits` (the largest
    of the filtered logits plus Gumbel noise from ``generator``, as
    ``jax.random.categorical`` draws)."""
    if decode == "greedy":
        return (logits.float() / temperature).argmax(dim=-1)
    filtered = filter_logits(logits, top_k, top_p, temperature)
    return (filtered + draw_gumbel(filtered.shape, generator)).argmax(dim=-1)


def _layer_norm(x, norm):
    """The fusion LayerNorm ``norm``'s plain version (fp32 statistics)."""
    return layer_norm_reference(x, norm.weight, norm.bias, norm.eps)


def _layer_fwd(layer, xq, keys, vals, bias, nh):
    """One fusion ``BertLayer`` for the query rows ``xq`` (B, Lq, D) against
    given ``keys`` / ``vals`` (B, Lk, D) under the additive fp32 ``bias``
    (B, Lq, Lk): the JAX ``_layer_fwd``, the scores and the context summed
    in fp32, the probabilities in the model dtype."""
    att = layer.attention
    b, lq, d = xq.shape
    lk, hd = keys.shape[1], d // nh
    q = att.self.query(xq).reshape(b, lq, nh, hd).transpose(1, 2).float()
    s = q @ keys.reshape(b, lk, nh, hd).permute(0, 2, 3, 1).float() / math.sqrt(hd)
    p = (s + bias[:, None]).softmax(dim=-1).to(xq.dtype)
    ctx = p.float() @ vals.reshape(b, lk, nh, hd).transpose(1, 2).float()
    ctx = ctx.to(xq.dtype).transpose(1, 2).reshape(b, lq, d)
    x = _layer_norm(att.output.dense(ctx) + xq, att.output.LayerNorm)
    h = layer.output.dense(F.gelu(layer.intermediate.dense(x)))
    return _layer_norm(h + x, layer.output.LayerNorm)


class VioletCaptioning(_Task):
    """(ref: model_for_captioning.py:35-237; JAX ``VioletCaptioning``) The
    trunk and ``fc_mtm``, an MLM head, built on ``device`` from ``seed``.
    The token ids are bert-base-uncased's unless given."""

    def __init__(self, config: ModelConfig, dtype=torch.float32, device="cuda",
                 seed: int = 0, cls_token_id: int = 101, sep_token_id: int = 102,
                 pad_token_id: int = 0, mask_token_id: int = 103):
        self.cls_token_id, self.sep_token_id = cls_token_id, sep_token_id
        self.pad_token_id, self.mask_token_id = pad_token_id, mask_token_id

        def heads(d):
            self.fc_mtm = BertMLMHead(config.fusion, dtype)
        super().__init__(config, dtype, device, seed, heads)

    def forward(self, img, txt, mask, generator=None):
        """The training pass: MLM logits (B, X, V) of the text positions
        under the seq2seq mask (ref: main_caption.py:56-68)."""
        fi, mi, ft, mt = self.go_feat(img, txt, mask, generator)
        out = self.go_cross(fi, mi, ft, mt, generator, "seq2seq")
        return self.fc_mtm(out[:, fi.shape[1]:])

    def _start(self, b, max_len, device):
        tokens = torch.full((b, max_len), self.pad_token_id, dtype=torch.int32, device=device)
        tokens[:, 0] = self.cls_token_id
        return tokens, torch.zeros(b, dtype=torch.bool, device=device)

    def next_logits(self, feat_img, mask_img, tokens, done, i):
        """The re-encoding decoder's logits (B, V) at position ``i``: the rows
        of ``tokens`` (B, max_len) with [MASK] at ``i`` ([PAD] where
        ``done``) fused with the video under the seq2seq mask."""
        cur = tokens.clone()
        cur[:, i] = torch.where(done, self.pad_token_id, self.mask_token_id).to(cur.dtype)
        b, max_len = tokens.shape
        mask_txt = (torch.arange(max_len, device=tokens.device) <= i).to(torch.int32)
        mask_txt = mask_txt.expand(b, max_len)
        out = self.go_cross(feat_img, mask_img, self.enc_txt(cur, mask_txt=mask_txt), mask_txt,
                            None, "seq2seq")
        return self.fc_mtm(out[:, feat_img.shape[1] + i])

    def _commit(self, tokens, done, i, nxt):
        nxt = torch.where(done, self.pad_token_id, nxt.to(torch.int32))
        tokens[:, i] = nxt
        return done | (nxt == self.sep_token_id)

    @torch.no_grad()
    def generate(self, img, max_len: int = 20, *, decode: str = "greedy", top_k: int = 0,
                 top_p: float = 0.0, temperature: float = 1.0,
                 generator: torch.Generator | None = None):
        """Autoregressive captions (B, max_len), [CLS] first (ref:
        model_for_captioning.py:114-165, 239-310; JAX ``generate`` with
        ``use_cache=False``): every position re-encodes the caption through
        the fusion. ``decode`` is ``greedy`` or a sampling mode (``top_k``,
        ``top_p``, ``temperature``; draws from ``generator``, seed 0 if
        none)."""
        fi, mi = self.enc_img(img)
        generator = generator or torch.Generator(fi.device).manual_seed(0)
        tokens, done = self._start(fi.shape[0], max_len, fi.device)
        for i in range(1, max_len):
            logits = self.next_logits(fi, mi, tokens, done, i)
            done = self._commit(tokens, done, i, sample_next(logits, decode, top_k, top_p,
                                                             temperature, generator))
        return tokens

    @torch.no_grad()
    def generate_cached(self, img, max_len: int = 20, *, decode: str = "greedy",
                        top_k: int = 0, top_p: float = 0.0, temperature: float = 1.0,
                        generator: torch.Generator | None = None):
        """The K/V-cached decoder (JAX ``generate_cached``). Video rows attend
        only video under the seq2seq mask, so each fusion layer's video
        half is computed once and its K/V kept; a text row at position p
        attends the video and the text at or before p, so computed against
        the cache it equals the full pass's. Each position runs one
        two-token forward, [the committed token at i-1, [MASK] at i],
        commits the first token's K/V at i-1 and samples token i from the
        second's logits. It needs the embeddings-only text encoder, as JAX
        asserts: a text stack re-encodes every earlier token at each
        position."""
        if self.enc_txt.txt_trsfr is not None:
            raise ValueError("the K/V-cached decoder needs the embeddings-only text encoder "
                             "(txt_backbone_embed_only); use generate")
        layers = self.trsfr.layer
        nh = self.config.fusion.num_attention_heads
        dtype = self.dtype
        fi, mi = self.enc_img(img)
        fi = fi.to(dtype)
        b, n_vid, d = fi.shape
        dev = fi.device
        generator = generator or torch.Generator(dev).manual_seed(0)
        neg = torch.finfo(torch.float32).min
        vid_part = (1.0 - mi.float()) * neg                          # (B, n_vid)
        # video prefill: the video rows alone, each layer's input K/V kept
        x, vid_kv = fi, []
        for layer in layers:
            sa = layer.attention.self
            vid_kv.append((sa.key(x), sa.value(x)))
            x = _layer_fwd(layer, x, *vid_kv[-1], vid_part[:, None, :].expand(b, n_vid, n_vid),
                           nh)
        emb = self.enc_txt.emb_txt

        def embed(ids, i):
            """BertEmbeddings of the pair at positions i-1 and i, token type 0."""
            e = (emb.word_embeddings.weight[ids.long()]
                 + emb.position_embeddings.weight[i - 1:i + 1][None]
                 + emb.token_type_embeddings.weight[0])
            return _layer_norm(e, emb.LayerNorm).to(dtype)

        tokens, done = self._start(b, max_len, dev)
        txt_k = torch.zeros((len(layers), b, max_len, d), dtype=dtype, device=dev)
        txt_v = torch.zeros_like(txt_k)
        # the pair's own bias: the token at i-1 does not see the [MASK] at i
        pair = torch.ones((2, 2), dtype=torch.bool, device=dev).triu(1)
        pair = torch.where(pair, neg, 0.0)
        slots = torch.arange(max_len, device=dev)
        for i in range(1, max_len):
            prev = tokens[:, i - 1]
            x = embed(torch.stack([prev, torch.full_like(prev, self.mask_token_id)], dim=1), i)
            # keys: [video ; the text cache before i-1 ; the pair itself]
            bias = torch.cat([vid_part[:, None, :].expand(b, 2, n_vid),
                              torch.where(slots <= i - 2, 0.0, neg).expand(b, 2, max_len),
                              pair.expand(b, 2, 2)], dim=2)
            for li, layer in enumerate(layers):
                sa = layer.attention.self
                k2, v2 = sa.key(x), sa.value(x)
                keys = torch.cat([vid_kv[li][0], txt_k[li], k2], dim=1)
                vals = torch.cat([vid_kv[li][1], txt_v[li], v2], dim=1)
                x = _layer_fwd(layer, x, keys, vals, bias, nh)
                txt_k[li, :, i - 1], txt_v[li, :, i - 1] = k2[:, 0], v2[:, 0]
            logits = self.fc_mtm(x[:, 1])
            done = self._commit(tokens, done, i, sample_next(logits, decode, top_k, top_p,
                                                             temperature, generator))
        return tokens

    @torch.no_grad()
    def generate_beam(self, img, max_len: int = 20, *, beam_size: int = 4,
                      length_penalty: float = 0.6):
        """Beam search (JAX ``generate_beam``): the B x ``beam_size``
        hypotheses of the re-encoding decoder run through one fusion pass a
        position; only beam 0 is live at the first position; a finished
        beam emits [PAD] at log-probability 0, so its score stays and still
        competes. Returns (B, max_len), each clip's best beam under score /
        length ** ``length_penalty`` (length counts the non-[PAD] tokens)."""
        k = beam_size
        fi, mi = self.enc_img(img)
        b, dev = fi.shape[0], fi.device
        fi_k, mi_k = fi.repeat_interleave(k, 0), mi.repeat_interleave(k, 0)
        flat, _ = self._start(b * k, max_len, dev)
        tokens = flat.reshape(b, k, max_len)
        scores = torch.where(torch.arange(k, device=dev) == 0, 0.0, -1e9).expand(b, k)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        for i in range(1, max_len):
            logits = self.next_logits(fi_k, mi_k, tokens.reshape(b * k, max_len),
                                      done.reshape(-1), i).float()
            v = logits.shape[-1]
            pad_only = torch.where(torch.arange(v, device=dev) == self.pad_token_id, 0.0,
                                   -math.inf)
            logp = torch.where(done[:, :, None], pad_only, logits.log_softmax(-1).reshape(b, k, v))
            scores, top = (scores[:, :, None] + logp).reshape(b, k * v).topk(k, dim=-1)
            beam = top // v
            tokens = tokens.gather(1, beam[:, :, None].expand(b, k, max_len))
            done = done.gather(1, beam)
            new = torch.where(done, self.pad_token_id, (top % v).to(torch.int32))
            tokens[:, :, i] = new
            done = done | (new == self.sep_token_id)
        lengths = (tokens != self.pad_token_id).sum(-1).clamp(min=1).float()
        best = (scores / lengths ** length_penalty).argmax(dim=-1)
        return tokens.gather(1, best[:, None, None].expand(b, 1, max_len))[:, 0]
