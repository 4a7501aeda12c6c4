"""Two-stage retrieval benchmark eval CLI (counterpart of
``empirical_mvm_tpu/cli/retrieval_eval.py``; ref: eval_retrieval_tsv.py):
the R@1/5/10 and MedR of BASELINE.md, every test (else val) caption against
every video, each video encoded over its temporal clips.

Usage:
  python -m empirical_mvm_torch.cli.retrieval_eval \
      --config configs/msrvtt-retrieval.json --path_ckpt ckpt.msgpack
"""

from __future__ import annotations

import json

from empirical_mvm_torch.cli import common
from empirical_mvm_torch.cli.retrieval import build_model
from empirical_mvm_torch.data.datasets import RetrievalDataset
from empirical_mvm_torch.data.jpeg import frame_decoder
from empirical_mvm_torch.data.loader import materialize
from empirical_mvm_torch.parallel.mesh import default_data_parallel
from empirical_mvm_torch.train.evaluators import retrieval_two_stage_eval


class DecodedClips:
    """A retrieval dataset whose ``multi_clip_item`` clips are decoded and
    transformed on ``device`` (``loader.materialize``): what
    ``retrieval_two_stage_eval`` encodes."""

    def __init__(self, dataset, device, decode=None):
        self.ds = dataset
        self.device = device
        self.decoder = frame_decoder(device, decode)
        self.gt_txt2vid = dataset.gt_txt2vid

    def __len__(self):
        return len(self.ds)

    def multi_clip_item(self, idx: int) -> dict:
        item = self.ds.multi_clip_item(idx)
        return {**item, "img": materialize({"img": [item["img"]]}, self.decoder,
                                           self.device)["img"][0]}


def eval_split(cfg, tokzr) -> tuple[str, RetrievalDataset]:
    img_src, txt = common.tsv_sources(cfg)
    split = "test" if "test" in txt else "val"
    return split, RetrievalDataset(cfg, split, tokzr, img_src, txt[split])


def main(argv=None, *, device="cuda", decode=None) -> dict:
    device = common.run_device(device, decode)
    cfg = common.setup_run(common.parse_cli(__doc__, argv), device)
    split, ds = eval_split(cfg, common.get_tokenizer(cfg))
    model = build_model(cfg, device)
    report = common.load_initial_params(cfg, model)
    metrics = retrieval_two_stage_eval(model, DecodedClips(ds, device, decode), device=device,
                                       dp=default_data_parallel())
    print(json.dumps({"task": cfg.task, "split": split, **metrics}), flush=True)
    return {"run_dir": cfg.path_output, "load": report, "split": split, **metrics}


if __name__ == "__main__":
    main()
