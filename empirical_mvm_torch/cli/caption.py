"""Video captioning CLI (counterpart of ``empirical_mvm_tpu/cli/caption.py``;
ref: main_caption.py, training at :114-163, inference at :70-112).

Train: the seq2seq-masked caption step with label-smoothed CE. Eval: 20
tokens generated for each clip (``CaptionAgent.generate``), detokenised,
and BLEU-4 / CIDEr-D / ROUGE-L / METEOR against the references.

Usage:
  python -m empirical_mvm_torch.cli.caption --config configs/caption.json
"""

from __future__ import annotations

import json

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.data.datasets import CaptionDataset
from empirical_mvm_torch.models.captioning import VioletCaptioning
from empirical_mvm_torch.parallel.mesh import all_gather_objects
from empirical_mvm_torch.train.agent import CaptionAgent
from empirical_mvm_torch.train.caption_metrics import caption_scores

EMPTY_SCORES = {"bleu4": 0.0, "cider": 0.0, "rouge_l": 0.0, "meteor": 0.0}


def build_model(cfg, tokzr, device, dtype=common.DTYPE) -> VioletCaptioning:
    return VioletCaptioning(cfg.model, dtype=dtype, device=device, seed=cfg.train.seed,
                            cls_token_id=tokzr.cls_token_id, sep_token_id=tokzr.sep_token_id,
                            pad_token_id=tokzr.pad_token_id,
                            mask_token_id=tokzr.mask_token_id)


def detokenize(row, tokzr) -> str:
    """Generated ids after [CLS] up to [SEP] or [PAD], word pieces joined
    by dropping their ``##`` (JAX ``cli/caption.py:137-150``)."""
    words = []
    for tid in row[1:]:
        if tid in (tokzr.sep_token_id, tokzr.pad_token_id):
            break
        words.append(tokzr.convert_ids_to_tokens([int(tid)])[0])
    return " ".join(w.replace("##", "") for w in words)


def merge_ranks(hyps: dict, refs: dict) -> tuple[dict, dict]:
    """Every rank's captions and references, merged (in rank order)."""
    all_hyps, all_refs = {}, {}
    for h, r in all_gather_objects((hyps, refs)):
        all_hyps.update(h)
        for vid, rows in r.items():
            all_refs.setdefault(vid, []).extend(rows)
    return all_hyps, all_refs


def main(argv=None, *, device="cuda", decode=None) -> dict:
    device = common.run_device(device, decode)
    cfg = common.setup_run(common.parse_cli(__doc__, argv), device)
    tokzr = common.get_tokenizer(cfg)
    img_src, txt = common.tsv_sources(cfg)
    datasets = {s: CaptionDataset(cfg, s, tokzr, img_src, txt[s])
                for s in common.splits_of(txt)}
    loaders = common.make_loaders(cfg, datasets)
    scores = {}
    try:
        model = build_model(cfg, tokzr, device)
        report = common.load_initial_params(cfg, model)
        max_iter = len(loaders["train"]) * cfg.train.size_epoch
        agent = CaptionAgent(cfg, model, device=device, decode=decode,
                             max_iter=max(max_iter, 1))

        def eval_fn(dl):
            hyps, refs = {}, {}
            for batch, db, n_valid in agent.eval_batches(dl):
                toks = agent.generate(db["img"]).cpu().numpy()[:n_valid]
                for i in range(n_valid):
                    vid = batch["vid"][i]
                    hyps[vid] = detokenize(toks[i], tokzr)
                    refs.setdefault(vid, []).append(batch["raw"][i])
            hyps, refs = merge_ranks(hyps, refs)
            return caption_scores(hyps, refs) if hyps else dict(EMPTY_SCORES)

        if cfg.train.size_epoch > 0:
            agent.fit(loaders["train"], loaders.get("val"), loaders.get("test"), eval_fn=eval_fn)
        else:
            for sname in ("val", "test"):
                if loaders.get(sname) is not None:
                    scores[sname] = eval_fn(loaders[sname])
                    print(sname, json.dumps(scores[sname]))
    finally:
        common.close_loaders(loaders)
    return {"run_dir": cfg.path_output, "load": report, "steps": agent.global_step,
            "log": dict(agent.log), "scores": scores}


if __name__ == "__main__":
    main()
