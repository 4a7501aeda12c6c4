"""Philox4x32-10 in integer tensor ops, and the attention-dropout keep mask it
gives: element (b, h, i, j) of a (B, nH, L, L) mask takes word j % 4 of
Philox at counter (j // 4, i, h, b) under the key (seed, offset), kept where
the word is at least p * 2^32. This is the generator the program's
attention kernels draw from (``csrc/common.cuh``), so the reference drops the
probabilities the program drops."""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) words of a * b for a 32-bit constant a and b int64 holding
    32-bit values; no intermediate exceeds 2^49."""
    t0 = b * (a & 0xFFFF)
    t1 = b * (a >> 16)
    mid = t0 + ((t1 & 0xFFFF) << 16)
    return ((t1 >> 16) + (mid >> 32)) & _MASK32, mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    for r in range(10):
        if r:
            k0 = (k0 + _W[0]) & _MASK32
            k1 = (k1 + _W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_M[0], c0)
        hi1, lo1 = _mulhilo(_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_keep(seed: torch.Tensor, shape, p_drop: float) -> torch.Tensor:
    """The (B, nH, L, Lk) bool keep mask of one attention call with dropout."""
    b, nh, l, lk = shape
    k0, k1 = (int(v) & _MASK32 for v in seed.tolist())
    dev = seed.device
    groups = -(-lk // 4)

    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=dev)

    words = philox4x32(ar(groups).view(1, 1, 1, -1), ar(l).view(1, 1, -1, 1),
                       ar(nh).view(1, -1, 1, 1), ar(b).view(-1, 1, 1, 1), k0, k1)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, nh, l, groups * 4)
    return bits[..., :lk] >= min(_MASK32, int(p_drop * 2.0 ** 32))
