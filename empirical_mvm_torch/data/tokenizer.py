"""BERT WordPiece tokenizer and the text encoding helpers (counterpart of
``empirical_mvm_tpu/data/tokenizer.py``; ref: dataset.py:22, 54-89,
208-218, main_qamc_tsv_mlm_gen_ans_idx.py:14-45).

The standard BERT basic + WordPiece algorithm over a ``vocab.txt``, with no
dependency on ``transformers``: fixed-length encode and pad
(:func:`str2txt`), the ``[SEP]`` concat (:func:`concat_txt`) and the four
``[MASK]`` placements, append, prepend, insert and replace
(:func:`str2txt_with_mask_tok`).
"""

from __future__ import annotations

import logging
import os
import unicodedata
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _is_whitespace(ch):
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punct(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over a plain vocab file."""

    def __init__(self, vocab: dict[str, int] | Sequence[str],
                 lowercase: bool = True, max_chars_per_word: int = 100):
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab = vocab
        self.inv_vocab = {i: t for t, i in vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.cls_token, self.sep_token = "[CLS]", "[SEP]"
        self.pad_token, self.mask_token, self.unk_token = "[PAD]", "[MASK]", "[UNK]"

    @classmethod
    def from_vocab_file(cls, path: str, lowercase: bool = True):
        with open(path, encoding="utf-8") as f:
            toks = [line.rstrip("\n") for line in f]
        return cls(toks, lowercase=lowercase)

    # --- basic tokenization (whitespace + punctuation + CJK splitting) ---

    def _basic_tokenize(self, text: str) -> list[str]:
        out = []
        clean = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            clean.append(" " if _is_whitespace(ch) else ch)
        for word in "".join(clean).split():
            if self.lowercase:
                word = word.lower()
                word = "".join(c for c in unicodedata.normalize("NFD", word)
                               if unicodedata.category(c) != "Mn")
            buf = []
            for ch in word:
                cp = ord(ch)
                cjk = (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                       or 0xF900 <= cp <= 0xFAFF)
                if _is_punct(ch) or cjk:
                    if buf:
                        out.append("".join(buf))
                        buf = []
                    out.append(ch)
                else:
                    buf.append(ch)
            if buf:
                out.append("".join(buf))
        return out

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    @property
    def _special_tokens(self):
        return (self.cls_token, self.sep_token, self.pad_token,
                self.mask_token, self.unk_token)

    def tokenize(self, text: str) -> list[str]:
        # keep special tokens intact (HF tokenizers never split them; the
        # reference inlines " [SEP] " into raw strings, dataset.py:54)
        out = []
        pieces = [text]
        for sp in self._special_tokens:
            nxt = []
            for p in pieces:
                if p in self._special_tokens:
                    nxt.append(p)
                    continue
                parts = p.split(sp)
                for i, q in enumerate(parts):
                    if i:
                        nxt.append(sp)
                    if q:
                        nxt.append(q)
            pieces = nxt
        for p in pieces:
            if p in self._special_tokens:
                out.append(p)
                continue
            for word in self._basic_tokenize(p):
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> list[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> list[str]:
        return [self.inv_vocab.get(int(i), self.unk_token) for i in ids]

    def encode(self, text: str) -> list[int]:
        """[CLS] tokens [SEP], HF-compatible."""
        return self.convert_tokens_to_ids(
            [self.cls_token] + self.tokenize(text) + [self.sep_token])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # --- special ids (ref: dataset.py:24-30) ---

    @property
    def cls_token_id(self):
        return self.vocab[self.cls_token]

    @property
    def sep_token_id(self):
        return self.vocab[self.sep_token]

    @property
    def pad_token_id(self):
        return self.vocab[self.pad_token]

    @property
    def mask_token_id(self):
        return self.vocab[self.mask_token]

    @property
    def unk_token_id(self):
        return self.vocab[self.unk_token]


#: the port's byte-identical copy of the JAX package's bundled vocab
#: (bert-base-uncased layout: 30522 entries, [PAD]=0 / [UNK]=100 /
#: [CLS]=101 / [SEP]=102 / [MASK]=103, every printable ASCII character).
FALLBACK_VOCAB = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "fallback-uncased-vocab.txt")


def load_tokenizer(name_or_vocab_path: str = "bert-base-uncased") -> WordPieceTokenizer:
    """A ``vocab.txt`` path, else the bundled fallback vocab, logged as the
    JAX package logs it when no HF tokenizer is available offline.

    The fallback matches bert-base-uncased's special-token ids and size but
    not its word-level ids: to reproduce a released checkpoint's text
    pipeline, pass the official vocab.txt.
    """
    if name_or_vocab_path.endswith(".txt"):
        return WordPieceTokenizer.from_vocab_file(name_or_vocab_path)
    logger.warning("tokenizer %r not available offline; using the bundled "
                   "fallback vocab %s", name_or_vocab_path, FALLBACK_VOCAB)
    return WordPieceTokenizer.from_vocab_file(FALLBACK_VOCAB)


def str2txt(tokzr, s: str, size_txt: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-length encode + pad (ref: dataset.py:208-218)."""
    ids = tokzr.encode(s)[: size_txt - 1]
    pad = tokzr.pad_token_id
    ids = ids + [pad] * (size_txt - len(ids))
    txt = np.asarray(ids, np.int32)
    mask = (txt != pad).astype(np.int32)
    return txt, mask


def concat_txt(tokzr, a: str, b: str) -> str:
    """(ref: dataset.py:54-56)"""
    return f"{a} {tokzr.sep_token} {b}"


def str2txt_with_mask_tok(tokzr, s: str, size_txt: int,
                          mask_pos: str = "append"):
    """Tokenize + place one [MASK] per the configured policy
    (ref: main_qamc_tsv_mlm_gen_ans_idx.py:14-45,
    main_qaoe_tsv_mlm_head.py:27-52 'append' adds 'answer:' [MASK])."""
    toks = tokzr.tokenize(s)[: size_txt - 1]
    pad_len = size_txt - len(toks)
    if mask_pos == "append":
        toks = [tokzr.cls_token] + toks + [tokzr.mask_token, tokzr.sep_token]
    elif mask_pos == "prepend":
        toks = [tokzr.mask_token, tokzr.cls_token] + toks + [tokzr.sep_token]
    elif mask_pos == "replace":
        toks = [tokzr.mask_token] + toks + [tokzr.sep_token]
    elif mask_pos == "insert":
        toks = [tokzr.cls_token] + toks + [tokzr.sep_token]
        if len(toks) < 10:
            toks += [tokzr.mask_token]
        else:
            toks = toks[:10] + [tokzr.mask_token] + toks[10:]
    else:
        raise ValueError(mask_pos)
    toks = toks + [tokzr.pad_token] * pad_len
    ids = np.asarray(tokzr.convert_tokens_to_ids(toks), np.int32)
    mask = (ids != tokzr.pad_token_id).astype(np.int32)
    return ids, mask
