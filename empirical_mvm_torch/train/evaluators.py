"""Two-stage retrieval evaluation (counterpart of
``empirical_mvm_tpu/train/evaluators.py:23-145``, single device).

Stage 1 encodes every (caption, video) item; stage 2 cross-scores every
(caption, video) pair and ranks them into R@1/5/10 and MedR
(ref: eval_retrieval.py:96-115, eval_retrieval_tsv.py:47-92).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def retrieval_two_stage_eval(model, dataset, *, chunk_size: int = 512,
                             encode_batch: int = 32, device="cuda") -> dict:
    """Encode every item, cross-score all (text, video) pairs, rank.

    ``model`` is a :class:`VioletRetrieval` on ``device``. ``dataset`` has
    ``__len__``, ``multi_clip_item(i)`` returning ``{"img": uint8 (Clips, T,
    H, W, 3), "txt", "mask", "vid", "tid"}``, and ``gt_txt2vid``.

    Stage 1 batches items of equal clip count, ``encode_batch`` at a time.
    Stage 2 keeps the feature banks on the device and gathers each chunk's
    rows there by index, ``chunk_size`` pairs per call with the last chunk
    padded to full size. Besides the metrics, the result holds the seconds of
    each stage (``_stage1_s``, ``_stage2_s``, each ending in a device
    synchronise) and the work done (``_clips``, ``_pairs``).
    """
    device = torch.device(device)
    n = len(dataset)
    items = [dataset.multi_clip_item(i) for i in range(n)]
    by_clips: dict[int, list[int]] = {}
    for i, it in enumerate(items):
        by_clips.setdefault(it["img"].shape[0], []).append(i)

    def put(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        rows: dict[int, tuple[int, int]] = {}        # item -> (batch, row)
        outs: list[tuple[torch.Tensor, ...]] = []
        for idxs in by_clips.values():
            for c0 in range(0, len(idxs), encode_batch):
                sel = idxs[c0:c0 + encode_batch]
                outs.append(model.encode(put([items[i]["img"] for i in sel]),
                                         put([items[i]["txt"] for i in sel]),
                                         put([items[i]["mask"] for i in sel])))
                rows.update({i: (len(outs) - 1, j) for j, i in enumerate(sel)})
        _sync(device)
        t1 = time.perf_counter()

        def bank(k: int, order: Sequence[int]) -> torch.Tensor:
            return torch.stack([outs[rows[i][0]][k][rows[i][1]] for i in order])

        vids = sorted({it["vid"] for it in items})
        first = {}                                   # first item of each video
        for i, it in enumerate(items):
            first.setdefault(it["vid"], i)
        vrows = [first[v] for v in vids]
        fi, mi = bank(0, vrows), bank(1, vrows)
        ft, mt = bank(2, range(n)), bank(3, range(n))

        n_txt, n_vid = n, len(vids)
        ti_all, vj_all = np.meshgrid(np.arange(n_txt), np.arange(n_vid), indexing="ij")
        ti_all, vj_all = ti_all.ravel(), vj_all.ravel()
        n_pairs = n_txt * n_vid
        scores = torch.zeros((n_txt, n_vid), dtype=torch.float32, device=device)
        for c0 in range(0, n_pairs, chunk_size):
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
        scores = scores.cpu().numpy()
        t2 = time.perf_counter()

    vid2col = {v: j for j, v in enumerate(vids)}
    gt = [vid2col[dataset.gt_txt2vid[it["tid"]]] for it in items]
    out = rank_metrics(scores, gt)
    out.update(_stage1_s=t1 - t0, _stage2_s=t2 - t1,
               _clips=float(sum(it["img"].shape[0] for it in items)),
               _pairs=float(n_pairs))
    return out
