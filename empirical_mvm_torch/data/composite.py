"""YAML-manifest composite TSV datasets (counterpart of
``empirical_mvm_tpu/data/composite.py``; ref: dataset.py:260-462,
main_pretrain_yaml.py:10-105).

A manifest names the ``img``, ``caption`` and ``label`` TSVs and a
``caption_linelist`` of (img_line, cap_line); a composite manifest spans
sharded TSVs with per-shard source indices, which give shards an affinity
to hosts (:func:`shard_affinity_indices`).

The port does not depend on PyYAML: :func:`load_yaml_manifest` reads
the flat ``key: value`` subset that manifests use, as ``yaml.safe_load``
reads it: strings (plain or quoted), decimal ints, booleans, comments. It
raises on anything else: indentation (nesting), lists, flow collections,
anchors, tags, block or multi-line scalars, null, floats and other numbers.
"""

from __future__ import annotations

import json
import logging
import os.path as op
import random
import re

import numpy as np

from empirical_mvm_torch.data.datasets import DatasetBase
from empirical_mvm_torch.data.tsv import CompositeTSVFile, TSVFile, tsv_reader

logger = logging.getLogger(__name__)

_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.\-]*)[ \t]*:(?:[ \t]+(.*))?$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_NUMERIC = re.compile(r"^[-+]?[.0-9]")
# YAML 1.1 booleans as PyYAML resolves them
_BOOLS = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")},
          **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                "OFF")}}
_NULLS = {"~", "null", "Null", "NULL"}


def _scalar(text: str, where: str):
    """One value of the flat subset, its trailing comment removed."""
    if text[:1] in ("'", '"'):
        q = text[0]
        body, i = [], 1
        while i < len(text):
            ch = text[i]
            if ch == q and q == "'" and text[i + 1:i + 2] == "'":
                body.append("'")
                i += 2
                continue
            if ch == "\\" and q == '"':
                if text[i + 1:i + 2] not in ('"', "\\"):
                    raise ValueError(f"{where}: escape {text[i:i + 2]!r} is outside the "
                                     "manifest subset")
                body.append(text[i + 1])
                i += 2
                continue
            if ch == q:
                rest = text[i + 1:].strip()
                if rest and not rest.startswith("#"):
                    raise ValueError(f"{where}: text after a quoted value")
                return "".join(body)
            body.append(ch)
            i += 1
        raise ValueError(f"{where}: unterminated quoted value (multi-line values are "
                         "outside the manifest subset)")
    value = re.split(r"[ \t]#", text, maxsplit=1)[0].rstrip()
    if not value or value[0] in "[]{}&*!|>%@`,#" or (
            value[0] in "-?:" and value[1:2] in ("", " ", "\t")):
        raise ValueError(f"{where}: {value!r} is outside the flat key: value subset")
    if ": " in value or value.endswith(":"):
        raise ValueError(f"{where}: a nested mapping is outside the manifest subset")
    if value in _BOOLS:
        return _BOOLS[value]
    if value in _NULLS:
        raise ValueError(f"{where}: null is outside the manifest subset")
    if _INT.match(value):
        return int(value.replace("_", ""))
    if _NUMERIC.match(value) or value.lower() in (".inf", "-.inf", "+.inf", ".nan"):
        raise ValueError(f"{where}: {value!r}: only decimal ints are in the manifest subset")
    return value


def parse_manifest(text: str, name: str = "manifest") -> dict:
    """The flat ``key: value`` subset of YAML (see the module's docstring)."""
    out: dict = {}
    for n, line in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line in ("---", "...") or line[0] in " \t":
            raise ValueError(f"{where}: documents and indentation are outside the "
                             "manifest subset")
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"{where}: not a flat key: value line: {line!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        if not value or value.startswith("#"):
            raise ValueError(f"{where}: {key!r} has no value on its line (nesting and "
                             "null are outside the manifest subset)")
        if key in out:
            raise ValueError(f"{where}: {key!r} given twice")
        out[key] = _scalar(value, where)
    return out


def load_yaml_manifest(path: str) -> dict:
    """(ref: utils/load_files.py:61 load_from_yaml_file)"""
    with open(path) as f:
        return parse_manifest(f.read(), path)


def find_file_path_in_yaml(fname: str | None, root: str) -> str | None:
    """(ref: utils/load_files.py:66)"""
    if fname is None:
        return None
    if op.isfile(fname):
        return fname
    cand = op.join(root, fname)
    if op.isfile(cand):
        return cand
    raise FileNotFoundError(f"{fname} (root={root})")


class CompositeYamlDataset(DatasetBase):
    """(ref: dataset.py:260-462). Yields the meta dict of
    ``get_img_txt_pair`` (ref: dataset.py:444-462) with a clip plan; the
    clip is drawn from the item's own rng (the JAX ``decode_clip(bufs)``
    draws from the shared ``self.rng``)."""

    def __init__(self, cfg, yaml_file: str, split: str = "train", tokzr=None):
        super().__init__(cfg, split, tokzr)
        if not op.isfile(yaml_file):
            yaml_file = op.join(cfg.data.data_dir, yaml_file)
        self.yaml_file = yaml_file
        self.root = op.dirname(yaml_file)
        self.manifest = load_yaml_manifest(yaml_file)
        self.is_composite = self.manifest.get("composite", False)
        self.cap_linelist_file = find_file_path_in_yaml(
            self.manifest.get("caption_linelist"), self.root)

        self.visual_tsv = self._get_tsv(self.manifest.get("img"))
        self.label_tsv = self._get_tsv(self.manifest.get("label"))
        self.cap_tsv = self._get_tsv(self.manifest.get("caption"))

        if self.is_composite:
            if not self.cap_linelist_file:
                raise ValueError(f"{yaml_file}: a composite manifest needs caption_linelist")
            self.cap_line_list = [int(row[2]) for row in tsv_reader(self.cap_linelist_file)]
            self.img_line_list = list(range(len(self.cap_line_list)))
        elif self.cap_linelist_file:
            rows = list(tsv_reader(self.cap_linelist_file))
            self.img_line_list = [int(r[0]) for r in rows]
            self.cap_line_list = [int(r[1]) for r in rows]
        else:
            n = self.cap_tsv.num_rows() if self.cap_tsv else self.visual_tsv.num_rows()
            self.img_line_list = list(range(n))
            self.cap_line_list = [0] * n
        if cfg.data.data_ratio != 1 and split == "train":
            self._partial(cfg.data.data_ratio)

    def _get_tsv(self, spec):
        if not spec:
            return None
        if self.is_composite:
            return CompositeTSVFile(spec, self.cap_linelist_file, root=self.root)
        return TSVFile(find_file_path_in_yaml(spec, self.root),
                       generate_lineidx_if_missing=True)

    def _partial(self, ratio: float):
        """(ref: dataset.py:310-322)"""
        idx = list(range(len(self.img_line_list)))
        rng = random.Random(self.cfg.train.seed)
        rng.shuffle(idx)
        n = (int(np.ceil(len(idx) * ratio)) if ratio < 1 else min(int(ratio), len(idx)))
        keep = idx[:n]
        self.img_line_list = [self.img_line_list[i] for i in keep]
        self.cap_line_list = [self.cap_line_list[i] for i in keep]

    def get_composite_source_idx(self) -> list[int]:
        """(ref: dataset.py:330-335) for shard->host affinity."""
        if self.is_composite:
            return [int(row[0]) for row in tsv_reader(self.cap_linelist_file)]
        return [0] * len(self.cap_line_list)

    def __len__(self):
        return len(self.img_line_list)

    def get_caption(self, img_idx: int, cap_idx: int) -> str:
        """(ref: dataset.py:372-377, 393-422)"""
        if self.cap_tsv is None:
            return ""
        data = json.loads(self.cap_tsv[img_idx][1])
        if isinstance(data, dict):           # MERLOT-style (ref :379-391)
            caps = data.get("captions") or [data.get("caption", "")]
            return caps[0]
        return data[cap_idx].get("caption", "")

    def __getitem__(self, idx: int):
        img_idx, cap_idx = self.img_line_list[idx], self.cap_line_list[idx]
        caption = (self.get_caption(img_idx, cap_idx)
                   if self.split == "train" or self.cap_tsv else "")
        bufs = self.visual_tsv[img_idx][2:]
        if bufs:
            img, corrupt = self.clip_plan(bufs, self.item_rng(idx))
        else:
            img, corrupt = self.zero_plan(), True
        if corrupt:
            caption = ""
        txt, mask = self.str2txt(caption)
        h = w = self.size_img // self.cfg.model.size_patch
        vq = np.full((img.shape[0] * (1 + h * w),), -1, np.int32)
        return {"img": img, "txt": txt, "mask": mask, "vq": vq}


def shard_affinity_indices(source_idx: list[int], num_hosts: int, host_index: int,
                           seed: int = 88, shuffle: bool = True) -> np.ndarray:
    """NodeSplitSampler-equivalent shard->host affinity
    (ref: swinbert/data_sampler.py:98-193): whole source shards are assigned
    to hosts so each host touches few files, then rows shuffle within the
    host's shards."""
    source_idx = np.asarray(source_idx)
    shards = np.unique(source_idx)
    rs = np.random.RandomState(seed)
    order = rs.permutation(len(shards))
    my_shards = set(shards[order[host_index::num_hosts]].tolist())
    mine = np.where(np.isin(source_idx, list(my_shards)))[0]
    if shuffle:
        rs2 = np.random.RandomState(seed + 1 + host_index)
        rs2.shuffle(mine)
    return mine
