"""Caption evaluation metrics: BLEU-4, CIDEr-D, ROUGE-L, METEOR (the port's
own copy of ``empirical_mvm_tpu/train/caption_metrics.py``, which imports
no JAX; the port imports nothing of the JAX package).

The reference delegates to a vendored ``evalcap`` COCO toolkit that is
missing from its tree (ref: main_caption.py:13). The four metrics are
implemented from their public definitions (Papineni et al. 2002; Vedantam
et al. 2015; Lin 2004; Banerjee & Lavie 2005) on whitespace-tokenized
strings, like the COCO toolkit after PTB tokenization. METEOR uses the
exact and Porter-stem matchers; the WordNet synonym module is not
available offline, so its scores are a close lower bound of the METEOR 1.5
jar's.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Mapping, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(hypotheses: Mapping[str, str],
          references: Mapping[str, Sequence[str]]) -> float:
    """Corpus BLEU-4 with uniform weights and brevity penalty."""
    p_num = [0] * 4
    p_den = [0] * 4
    hyp_len = 0
    ref_len = 0
    for key, hyp in hypotheses.items():
        h = hyp.split()
        refs = [r.split() for r in references[key]]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in refs)[1]
        for n in range(1, 5):
            hng = _ngrams(h, n)
            best = Counter()
            for r in refs:
                rng = _ngrams(r, n)
                for g, c in rng.items():
                    best[g] = max(best[g], c)
            clipped = sum(min(c, best[g]) for g, c in hng.items())
            p_num[n - 1] += clipped
            p_den[n - 1] += max(sum(hng.values()), 0)
    if min(p_num) == 0:
        return 0.0
    log_p = sum(math.log(p_num[i] / p_den[i]) for i in range(4)) / 4
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_p)


def cider_d(hypotheses: Mapping[str, str],
            references: Mapping[str, Sequence[str]],
            n_max: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D: tf-idf weighted n-gram cosine similarity with length
    penalty, averaged over n in 1..4 and references."""
    # document frequencies over reference sets
    doc_freq: list[Counter] = [Counter() for _ in range(n_max)]
    for refs in references.values():
        for n in range(n_max):
            seen = set()
            for r in refs:
                seen.update(_ngrams(r.split(), n + 1).keys())
            for g in seen:
                doc_freq[n][g] += 1
    n_docs = max(len(references), 1)

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n + 1)
        total = max(sum(cnt.values()), 1)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            df = math.log(max(doc_freq[n][g], 1))
            w = (c / total) * max(math.log(n_docs) - df, 0.0)
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm), len(tokens)

    scores = []
    for key, hyp in hypotheses.items():
        h_toks = hyp.split()
        score_n = [0.0] * n_max
        for n in range(n_max):
            hv, hnorm, hlen = tfidf_vec(h_toks, n)
            for r in references[key]:
                r_toks = r.split()
                rv, rnorm, rlen = tfidf_vec(r_toks, n)
                num = sum(min(hv.get(g, 0.0), rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g in hv)
                denom = hnorm * rnorm
                sim = num / denom if denom > 0 else 0.0
                sim *= math.exp(-((hlen - rlen) ** 2) / (2 * sigma ** 2))
                score_n[n] += sim
            score_n[n] /= max(len(references[key]), 1)
        scores.append(10.0 * sum(score_n) / n_max)
    return sum(scores) / max(len(scores), 1)


def _lcs_table(a: Sequence[str], b: Sequence[str]) -> list[list[int]]:
    la, lb = len(a), len(b)
    t = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la):
        row, prev = t[i + 1], t[i]
        ai = a[i]
        for j in range(lb):
            row[j + 1] = prev[j] + 1 if ai == b[j] \
                else max(row[j], prev[j + 1])
    return t


def rouge_l(hypotheses: Mapping[str, str],
            references: Mapping[str, Sequence[str]],
            beta: float = 1.2) -> float:
    """ROUGE-L F-measure (Lin 2004), COCO-toolkit convention: per item take
    the max F over references (beta=1.2), average over the corpus."""
    scores = []
    for key, hyp in hypotheses.items():
        h = hyp.split()
        best = 0.0
        for ref in references[key]:
            r = ref.split()
            if not h or not r:
                continue
            lcs = _lcs_table(h, r)[len(h)][len(r)]
            prec, rec = lcs / len(h), lcs / len(r)
            if prec > 0 and rec > 0:
                f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)
                best = max(best, f)
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


_PORTER_STEP1B = (("sses", "ss"), ("ies", "i"), ("ss", "ss"), ("s", ""))


def _light_stem(w: str) -> str:
    """Porter step-1-style light stemmer (suffix stripping): enough to merge
    the inflection families METEOR's stem module targets."""
    for suf, rep in _PORTER_STEP1B:
        if w.endswith(suf):
            w = w[: len(w) - len(suf)] + rep
            break
    for suf in ("ing", "ed"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            stem = w[: len(w) - len(suf)]
            if any(c in "aeiouy" for c in stem):
                w = stem
            break
    if w.endswith("ly") and len(w) > 4:
        w = w[:-2]
    return w


def _meteor_align(h: Sequence[str], r: Sequence[str]) -> tuple[int, int]:
    """(matches, chunks): order-preserving unigram alignment via LCS on the
    exact-or-stem-matched tokens; chunks = contiguous runs of the alignment
    (Banerjee & Lavie 2005 penalty term)."""
    hs = [_light_stem(w) for w in h]
    rs = [_light_stem(w) for w in r]
    la, lb = len(hs), len(rs)
    t = _lcs_table(hs, rs)
    # backtrack the LCS into aligned index pairs
    pairs = []
    i, j = la, lb
    while i > 0 and j > 0:
        if hs[i - 1] == rs[j - 1] and t[i][j] == t[i - 1][j - 1] + 1:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif t[i - 1][j] >= t[i][j - 1]:
            i -= 1
        else:
            j -= 1
    pairs.reverse()
    if not pairs:
        return 0, 0
    chunks = 1
    for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
        if i1 != i0 + 1 or j1 != j0 + 1:
            chunks += 1
    return len(pairs), chunks


def meteor(hypotheses: Mapping[str, str],
           references: Mapping[str, Sequence[str]],
           alpha: float = 0.9, beta: float = 3.0,
           gamma: float = 0.5) -> float:
    """METEOR (exact + stem matchers; no WordNet synonyms offline). Per item
    the max score over references, averaged over the corpus."""
    scores = []
    for key, hyp in hypotheses.items():
        h = hyp.split()
        best = 0.0
        for ref in references[key]:
            r = ref.split()
            if not h or not r:
                continue
            m, chunks = _meteor_align(h, r)
            if m == 0:
                continue
            prec, rec = m / len(h), m / len(r)
            f_mean = prec * rec / (alpha * prec + (1 - alpha) * rec)
            penalty = gamma * (chunks / m) ** beta
            best = max(best, f_mean * (1 - penalty))
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def caption_scores(hypotheses: Mapping[str, str],
                   references: Mapping[str, Sequence[str]]) -> dict:
    return {"bleu4": bleu4(hypotheses, references) * 100,
            "cider": cider_d(hypotheses, references),
            "rouge_l": rouge_l(hypotheses, references) * 100,
            "meteor": meteor(hypotheses, references) * 100}
