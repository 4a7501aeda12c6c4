"""Text-to-video retrieval fine-tune CLI (counterpart of
``empirical_mvm_tpu/cli/retrieval.py``; ref: main_retrieval_tsv.py).

Usage:
  python -m empirical_mvm_torch.cli.retrieval --config configs/msrvtt-retrieval.json \
      --path_ckpt ckpt_violet_pretrain_final_N.msgpack
"""

from __future__ import annotations

import numpy as np

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.data.datasets import RetrievalDataset
from empirical_mvm_torch.models.tasks import VioletRetrieval
from empirical_mvm_torch.parallel.mesh import all_gather_metrics, process_count, process_index
from empirical_mvm_torch.train.agent import RetrievalAgent
from empirical_mvm_torch.train.evaluators import in_batch_retrieval_accuracy


def build_model(cfg, device, dtype=common.DTYPE) -> VioletRetrieval:
    return VioletRetrieval(cfg.model, dtype=dtype, device=device, seed=cfg.train.seed)


def main(argv=None, *, device="cuda", decode=None) -> dict:
    device = common.run_device(device, decode)
    cfg = common.setup_run(common.parse_cli(__doc__, argv), device)
    tokzr = common.get_tokenizer(cfg)
    img_src, txt = common.tsv_sources(cfg)
    datasets = {s: RetrievalDataset(cfg, s, tokzr, img_src, txt[s])
                for s in common.splits_of(txt)}
    loaders = common.make_loaders(cfg, datasets)
    try:
        model = build_model(cfg, device)
        report = common.load_initial_params(cfg, model)
        max_iter = len(loaders["train"]) * cfg.train.size_epoch
        agent = RetrievalAgent(cfg, model, device=device, decode=decode,
                               max_iter=max(max_iter, 1))

        def eval_fn(dl):
            accs = []
            w = process_count()
            for _, db, n_valid in agent.eval_batches(dl):
                scores = agent.eval_forward(db).float().cpu().numpy()
                accs.append(in_batch_retrieval_accuracy(scores[:n_valid, :n_valid * w],
                                                        process_index(), w))
            accs = all_gather_metrics(accs)
            return float(np.mean(accs)) if accs else 0.0

        if cfg.train.size_epoch > 0:
            agent.fit(loaders["train"], loaders.get("val"), loaders.get("test"), eval_fn=eval_fn)
        else:
            for s in ("val", "test"):
                if loaders.get(s) is not None:
                    print(s, eval_fn(loaders[s]))
    finally:
        common.close_loaders(loaders)
    return {"run_dir": cfg.path_output, "load": report, "steps": agent.global_step,
            "log": dict(agent.log)}


if __name__ == "__main__":
    main()
