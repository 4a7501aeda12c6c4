"""Convert a released PyTorch VIOLET checkpoint to the flax ``.msgpack`` (or
``.npz``) that both packages load (counterpart of
``empirical_mvm_tpu/cli/convert_ckpt.py``; ref: model.py:295-353).

Usage:
  python -m empirical_mvm_torch.cli.convert_ckpt \
      --src ckpt_violet_pretrain.pt --dst violet_pretrain.msgpack \
      [--config configs/msrvtt-retrieval.json] [--heads fc=score_head]

``--config`` gives the geometry the position embeddings are cut to (the
base VIOLET geometry without it); ``--heads`` names the heads to carry and
their kinds (``score_head``, ``mlm_head``, ``linear``), as the task CLIs
name them; without it no head is carried, as in the JAX converter.
"""

from __future__ import annotations

import argparse
import logging

from empirical_mvm_torch.core.config import ModelConfig, load_run_config
from empirical_mvm_torch.train.checkpoint import load_torch_violet_ckpt, save_params

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help=".pt/.pth/.bin torch ckpt")
    ap.add_argument("--dst", required=True, help=".msgpack or .npz output")
    ap.add_argument("--config", default=None,
                    help="task JSON for model geometry (pos-emb slicing); "
                         "defaults to the base VIOLET geometry")
    ap.add_argument("--heads", nargs="*", default=[], metavar="NAME=KIND",
                    help="heads to carry, with their kinds")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    model_cfg = load_run_config(args.config).model if args.config else ModelConfig()
    heads = dict(kv.split("=", 1) for kv in args.heads)
    sd = load_torch_violet_ckpt(args.src, model_cfg)
    save_params(sd, args.dst, meta={"source": args.src}, heads=heads)
    n = sum(v.numel() for v in sd.values())
    logger.info("wrote %s (%d params, %.1f MB)", args.dst, n, n * 4 / 1e6)
    return {"dst": args.dst, "params": n}


if __name__ == "__main__":
    main()
