"""Tiny copies of the benchmark's cells for CPU tests: the same entries,
configuration layout and traffic keys at a small width (the 2D Swin-base
teacher keeps its size: the program builds it from the target's name)."""

from __future__ import annotations

import copy
import json

from portbench.harness import spec

TINY_BERT = {"vocab_size": 1100, "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 64,
             "type_vocab_size": 2, "layer_norm_eps": 1e-12, "hidden_dropout_prob": 0.1,
             "attention_probs_dropout_prob": 0.1}
TINY_SWIN = {"patch_size": [2, 4, 4], "embed_dim": 16, "depths": [2, 2, 2, 2],
             "num_heads": [1, 2, 4, 8], "window_size": [8, 7, 7], "drop_path_rate": 0.2,
             "final_norm": True}


def tiny_cell(name: str, dtype: str = "float32", batch: int = 4,
              mvm_target: str | None = None) -> spec.Cell:
    """The benchmark cell ``name`` at a tiny width: 64^2 clips of 2 frames,
    8 text tokens, a 2-layer fusion of 64; a pretrain cell with
    ``mvm_target`` in place of its own."""
    cell = spec.load_cell(name)
    config = copy.deepcopy(cell.config)
    run = config["run"]
    run.update(size_img=64, size_frame=2, size_txt=8)
    if mvm_target is not None:
        run["mvm_target"] = [mvm_target]
    swin = {k: TINY_SWIN[k] for k in ("patch_size", "embed_dim", "depths", "num_heads",
                                      "window_size", "drop_path_rate")}
    run["swin_custom"] = swin
    run["fusion"] = {k: v for k, v in TINY_BERT.items()}
    run["text"] = dict(run["fusion"])
    config["dims"].update(swin=dict(TINY_SWIN), fusion=TINY_BERT, text=TINY_BERT)
    config["dtype"] = dtype
    traffic = dict(cell.traffic)
    if "batch" in traffic:
        traffic.update(batch=batch, pool=4, trace_steps=2)
    else:
        traffic.update(captions=6, clips=2, encode_batch=4, chunk_size=8, trace_evals=1)
    return spec.Cell(name=name, workload=dict(cell.workload), config=json.loads(json.dumps(config)),
                     traffic=traffic, limits=dict(cell.limits), end_to_end=cell.end_to_end,
                     per_layer=cell.per_layer)
