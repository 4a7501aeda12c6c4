"""QA fine-tune CLIs (counterpart of ``empirical_mvm_tpu/cli/qa.py``):
multiple choice (score head, generative MLM head, MLM head) and open-ended
(answer-vocab head, MLM head, LSMDC fill-in-the-blank), as the reference's
entry scripts:

  qamc      -> main_qamc_tsv.py                  (score head)
  qamc-gen  -> main_qamc_tsv_mlm_gen_ans_idx.py  (the TGIF path)
  qamc-mlm  -> the MLM-head multiple choice (true / false at [MASK])
  qaoe      -> main_qaoe_tsv.py                  (answer-vocab head)
  qaoe-mlm  -> main_qaoe_tsv_mlm_head.py         (the MSRVTT / MSVD-QA path)
  qaoe-fib  -> main_qaoe_tsv_lsmdc_fib.py        (LSMDC fill-in-the-blank)

Usage:
  python -m empirical_mvm_torch.cli.qa --mode qamc-gen --config configs/tgif-action.json
"""

from __future__ import annotations

import argparse

import numpy as np

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.data.datasets import (QAMCDataset, QAMCGenDataset, QAMCMLMDataset,
                                               QAOEDataset, QAOEMLMDataset)
from empirical_mvm_torch.models.tasks import (VioletQAMC, VioletQAMCGen, VioletQAMCMLMHead,
                                              VioletQAOE, VioletQAOEMLMHead,
                                              qamc_mlm_head_accuracy)
from empirical_mvm_torch.parallel.mesh import all_gather_metrics
from empirical_mvm_torch.train.agent import QAMCAgent, QAMCGenAgent, QAOEAgent, QAOEMLMAgent
from empirical_mvm_torch.train.evaluators import (qamc_accuracy, qamc_gen_accuracy,
                                                  qaoe_mlm_topk)

MODES = {
    "qamc": (QAMCDataset, VioletQAMC, QAMCAgent),
    "qamc-gen": (QAMCGenDataset, VioletQAMCGen, QAMCGenAgent),
    "qamc-mlm": (QAMCMLMDataset, VioletQAMCMLMHead, QAMCGenAgent),
    "qaoe": (QAOEDataset, VioletQAOE, QAOEAgent),
    "qaoe-mlm": (QAOEMLMDataset, VioletQAOEMLMHead, QAOEMLMAgent),
    "qaoe-fib": (QAOEMLMDataset, VioletQAOEMLMHead, QAOEMLMAgent),
}


def build_datasets(mode: str, cfg, tokzr, img_src, txt) -> dict:
    ds_cls = MODES[mode][0]
    datasets = {}
    for s in common.splits_of(txt):
        if mode == "qaoe":
            datasets[s] = ds_cls(cfg, s, tokzr, img_src, txt[s], txt.get("ans2label", {}))
        elif mode in ("qaoe-mlm", "qaoe-fib"):
            datasets[s] = ds_cls(cfg, s, tokzr, img_src, txt[s], fib=(mode == "qaoe-fib"))
        else:
            datasets[s] = ds_cls(cfg, s, tokzr, img_src, txt[s])
    return datasets


def build_model(mode: str, cfg, datasets, device, dtype=common.DTYPE):
    """``mode``'s model; the open-ended MLM modes with ``enable_prompt``
    take the run's fixed prompt (ref: main_qaoe_lsmdc_fib.py:135
    ``batch["prompt"] = get_prompt()``)."""
    kwargs = {}
    if mode in ("qaoe-mlm", "qaoe-fib") and cfg.model.enable_prompt:
        p_txt, _ = datasets["train"].get_prompt()
        kwargs["prompt_tokens"] = tuple(int(i) for i in p_txt)
    return MODES[mode][1](cfg.model, dtype=dtype, device=device, seed=cfg.train.seed, **kwargs)


def _host(x) -> np.ndarray:
    return x.float().cpu().numpy() if x.is_floating_point() else x.cpu().numpy()


def accuracies(mode: str, out: np.ndarray, batch: dict, datasets, tokzr) -> list[float]:
    """The eval metric of ``mode`` on one batch's ``n_valid`` outputs (JAX
    ``cli/qa.py`` ``eval_fn``)."""
    n = out.shape[0]
    if mode == "qamc":
        return [qamc_accuracy(out, _host(batch["ans"])[:n])]
    if mode == "qamc-mlm":
        return list(qamc_mlm_head_accuracy(out, _host(batch["mask_ans"])[:n],
                                           datasets["train"].true_token_id,
                                           datasets["train"].false_token_id))
    if mode == "qamc-gen":
        return list(qamc_gen_accuracy(out, _host(batch["txt"])[:n], tokzr.mask_token_id,
                                      datasets["train"].ans_tok_ids,
                                      _host(batch["ans_idx"])[:n]))
    if mode == "qaoe":
        return [float((np.argmax(out, -1) == _host(batch["ans"])[:n]).mean())]
    return list(qaoe_mlm_topk(out, _host(batch["mask_ans"])[:n], k=1))


def main(argv=None, *, device="cuda", decode=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True, choices=list(MODES))
    ap.add_argument("--config", required=True)
    ap.add_argument("--path_ckpt", default=None)
    args, rest = ap.parse_known_args(argv)
    device = common.run_device(device, decode)
    # the rest (--path_output, --size_epoch) goes to the shared parser
    cfg = common.parse_cli("qa", ["--config", args.config]
                           + (["--path_ckpt", args.path_ckpt] if args.path_ckpt else []) + rest)
    cfg = common.setup_run(cfg, device)
    tokzr = common.get_tokenizer(cfg)
    img_src, txt = common.tsv_sources(cfg)
    datasets = build_datasets(args.mode, cfg, tokzr, img_src, txt)
    loaders = common.make_loaders(cfg, datasets)
    try:
        model = build_model(args.mode, cfg, datasets, device)
        report = common.load_initial_params(cfg, model)
        max_iter = len(loaders["train"]) * cfg.train.size_epoch
        agent = MODES[args.mode][2](cfg, model, device=device, decode=decode,
                                    max_iter=max(max_iter, 1))

        def eval_fn(dl):
            accs = []
            for batch, db, n_valid in agent.eval_batches(dl):
                out = _host(agent.eval_forward(db))[:n_valid]
                accs.extend(accuracies(args.mode, out, batch, datasets, tokzr))
            accs = all_gather_metrics(accs)
            return float(np.mean(accs)) if accs else 0.0

        if cfg.train.size_epoch > 0:
            agent.fit(loaders["train"], loaders.get("val"), loaders.get("test"), eval_fn=eval_fn)
        else:
            for sname in ("val", "test"):
                if loaders.get(sname) is not None:
                    print(sname, eval_fn(loaders[sname]))
    finally:
        common.close_loaders(loaders)
    return {"run_dir": cfg.path_output, "load": report, "steps": agent.global_step,
            "log": dict(agent.log)}


if __name__ == "__main__":
    main()
