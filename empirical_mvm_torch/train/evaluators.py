"""Evaluators (counterpart of ``empirical_mvm_tpu/train/evaluators.py``,
single device): the two-stage retrieval evaluation, the in-batch
retrieval accuracy of fine-tune validation, and the QA metrics: the
multiple-choice accuracy, the generative multiple choice's accuracy over
the digit tokens and the open-ended MLM head's top-k accuracy. The metrics
are numpy functions over host arrays.

Stage 1 encodes every (caption, video) item; stage 2 cross-scores every
(caption, video) pair and ranks them into R@1/5/10 and MedR
(ref: eval_retrieval.py:96-115, eval_retrieval_tsv.py:47-92).
"""

from __future__ import annotations

import itertools
import time
from typing import Sequence

import numpy as np
import torch

from empirical_mvm_torch.core import tracing
from empirical_mvm_torch.parallel.mesh import (DataParallel, all_gather_objects,
                                               all_reduce_coalesced)

_EVALS = itertools.count()      # the request id of each two-stage eval's spans


def rank_metrics(score_matrix: np.ndarray, gt_idx: Sequence[int]) -> dict:
    """R@1/5/10 + MedR from a (n_text, n_video) score matrix
    (ref: eval_retrieval_tsv.py:79-92)."""
    s = np.asarray(score_matrix)
    gt = np.asarray(gt_idx)
    order = np.argsort(-s, axis=1)
    ranks = np.array([int(np.where(order[i] == gt[i])[0][0]) + 1
                      for i in range(len(gt))])
    return {"r1": float((ranks <= 1).mean() * 100),
            "r5": float((ranks <= 5).mean() * 100),
            "r10": float((ranks <= 10).mean() * 100),
            "medr": float(np.median(ranks))}


def qamc_accuracy(logits: np.ndarray, answers: np.ndarray) -> float:
    """Share of questions whose highest-scored option is the answer
    (ref: main_qamc.py:152-154)."""
    return float((np.argmax(logits, axis=1) == answers).mean())


def qamc_gen_accuracy(mlm_logits: np.ndarray, txt: np.ndarray, mask_token_id: int,
                      ans_tok_ids: Sequence[int], ans_idx: np.ndarray) -> list[float]:
    """Per question, 1 where the MLM logits at the first [MASK], taken over
    the digit tokens ``ans_tok_ids``, peak at ``ans_idx``; a row without
    [MASK] counts 0 (ref: main_qamc_tsv_mlm_gen_ans_idx.py:120-130).
    mlm_logits (B, X, V), txt (B, X)."""
    accs = []
    for b in range(mlm_logits.shape[0]):
        pos = np.where(txt[b] == mask_token_id)[0]
        if len(pos) == 0:
            accs.append(0.0)
            continue
        p = mlm_logits[b, pos[0], list(ans_tok_ids)]
        accs.append(float(int(np.argmax(p)) == int(ans_idx[b])))
    return accs


def qaoe_mlm_topk(mlm_logits: np.ndarray, mask_ans: np.ndarray, k: int = 5) -> list[float]:
    """Per row, 1 where the answer at the first position with mask_ans !=
    -1 is among the k largest logits there (``argpartition`` decides them);
    a row without an answer counts 0 (ref: main_qaoe_lsmdc_fib.py:105-116).
    mlm_logits (B, X, V), mask_ans (B, X)."""
    accs = []
    for i in range(mlm_logits.shape[0]):
        pos = np.where(mask_ans[i] != -1)[0]
        if len(pos) == 0:
            accs.append(0.0)
            continue
        topk = np.argpartition(-mlm_logits[i, pos[0]], k)[:k]
        accs.append(float(int(mask_ans[i, pos[0]]) in topk.tolist()))
    return accs


def in_batch_retrieval_accuracy(scores: np.ndarray, rank: int = 0, world: int = 1) -> float:
    """Share of the rows of a (B, B) score matrix whose largest score is on
    the diagonal, the retrieval fine-tune's validation metric
    (ref: main_retrieval.py:103-106). Across ranks, ``scores`` is rank
    ``rank``'s rows (B / W, B), row i's own caption at column i * W + rank."""
    own = np.arange(len(scores)) * world + rank
    return float((np.argmax(scores, axis=1) == own).mean())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def retrieval_two_stage_eval(model, dataset, *, chunk_size: int = 512,
                             encode_batch: int = 32, device="cuda",
                             dp: DataParallel | None = None) -> dict:
    """Encode every item, cross-score all (text, video) pairs, rank.

    ``model`` is a :class:`VioletRetrieval` on ``device``. ``dataset`` has
    ``__len__``, ``multi_clip_item(i)`` returning ``{"img": (Clips, T, H, W,
    3) uint8 or normalized float, an array or a tensor, "txt", "mask",
    "vid", "tid"}``, and ``gt_txt2vid``.

    Stage 1 batches items of equal clip count, ``encode_batch`` at a time.
    Stage 2 keeps the feature banks on the device and gathers each chunk's
    rows there by index, ``chunk_size`` pairs per call with the last chunk
    padded to full size. Besides the metrics, the result holds the seconds of
    each stage (``_stage1_s``, ``_stage2_s``, each ending in a device
    synchronise) and the work done (``_clips``, ``_pairs``).

    It opens the tracer's spans (``core/tracing.py``): ``eval`` around it
    (request id: the process's count of evals), ``eval.stage1`` and
    ``eval.stage2`` around the timed stages, and in each stage-1 input's
    copy ``eval.stack`` (the host's ``torch.stack``) and ``eval.h2d`` (its
    copy to ``device``).

    With ``dp``, rank r encodes the stage-1 batches and scores the stage-2
    chunks whose index is r modulo W, each the batch or chunk one process
    makes; the banks and the score matrix are summed over the ranks from
    zeros, which assembles them exactly, so every rank ranks the one-process
    scores (JAX pads the pair list to the mesh instead). Every rank reads
    every item.
    """
    tracing.request(next(_EVALS))
    with tracing.span("eval"):
        return _two_stage_eval(model, dataset, chunk_size, encode_batch, torch.device(device), dp)


def _two_stage_eval(model, dataset, chunk_size, encode_batch, device, dp) -> dict:
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    n = len(dataset)
    items = [dataset.multi_clip_item(i) for i in range(n)]
    by_clips: dict[int, list[int]] = {}
    for i, it in enumerate(items):
        by_clips.setdefault(it["img"].shape[0], []).append(i)
    batches = [idxs[c0:c0 + encode_batch] for idxs in by_clips.values()
               for c0 in range(0, len(idxs), encode_batch)]

    def put(arrays):
        with tracing.span("eval.stack"):
            host = torch.stack([torch.as_tensor(a) for a in arrays])
        with tracing.span("eval.h2d"):
            return host.to(device)

    with torch.inference_mode():
        with tracing.span("eval.stage1"):
            _sync(device)
            t0 = time.perf_counter()
            banks: list[torch.Tensor] | None = None          # per output, (n, ...)
            for j, sel in enumerate(batches):
                if j % world != rank:
                    continue
                outs = model.encode(put([items[i]["img"] for i in sel]),
                                    put([items[i]["txt"] for i in sel]),
                                    put([items[i]["mask"] for i in sel]))
                if banks is None:
                    banks = [torch.zeros((n, *o.shape[1:]), dtype=o.dtype, device=device)
                             for o in outs]
                rows = torch.as_tensor(sel, device=device)
                for bank, o in zip(banks, outs):
                    bank[rows] = o
            if dp is not None:
                banks = _assemble(banks, device)
            _sync(device)
            t1 = time.perf_counter()

        with tracing.span("eval.stage2"):
            vids = sorted({it["vid"] for it in items})
            first = {}                                   # first item of each video
            for i, it in enumerate(items):
                first.setdefault(it["vid"], i)
            vrows = torch.as_tensor([first[v] for v in vids], device=device)
            fi, mi = banks[0][vrows], banks[1][vrows]
            ft, mt = banks[2], banks[3]

            n_txt, n_vid = n, len(vids)
            ti_all, vj_all = np.meshgrid(np.arange(n_txt), np.arange(n_vid), indexing="ij")
            ti_all, vj_all = ti_all.ravel(), vj_all.ravel()
            n_pairs = n_txt * n_vid
            scores = torch.zeros((n_txt, n_vid), dtype=torch.float32, device=device)
            for j, c0 in enumerate(range(0, n_pairs, chunk_size)):
                if j % world != rank:
                    continue
                ti = ti_all[c0:c0 + chunk_size]
                vj = vj_all[c0:c0 + chunk_size]
                k = len(ti)
                if k < chunk_size:      # pad the tail chunk to the full shape
                    ti = np.concatenate([ti, np.full(chunk_size - k, ti[-1])])
                    vj = np.concatenate([vj, np.full(chunk_size - k, vj[-1])])
                ti_d = torch.from_numpy(ti).to(device)
                vj_d = torch.from_numpy(vj).to(device)
                out = model.score_pairs(fi[vj_d], mi[vj_d], ft[ti_d], mt[ti_d])
                scores[ti_d[:k], vj_d[:k]] = out[:k].float()
            if dp is not None:
                scores = _assemble([scores], device)[0]
            scores = scores.cpu().numpy()
            t2 = time.perf_counter()

    vid2col = {v: j for j, v in enumerate(vids)}
    gt = [vid2col[dataset.gt_txt2vid[it["tid"]]] for it in items]
    out = rank_metrics(scores, gt)
    out.update(_stage1_s=t1 - t0, _stage2_s=t2 - t1,
               _clips=float(sum(it["img"].shape[0] for it in items)),
               _pairs=float(n_pairs))
    return out


def _assemble(parts: list[torch.Tensor] | None, device) -> list[torch.Tensor]:
    """Tensors each rank filled in its own rows of zeros, summed over the
    ranks (exact: every element is one rank's value plus zeros). A rank that
    encoded no batch takes the shapes from rank 0."""
    spec = all_gather_objects(None if parts is None else
                              [(tuple(p.shape), p.dtype) for p in parts])
    spec = next(s for s in spec if s is not None)
    if parts is None:
        parts = [torch.zeros(shape, dtype=dt, device=device) for shape, dt in spec]
    all_reduce_coalesced(parts)
    return parts
