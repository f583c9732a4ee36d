"""Pure-Python NLG metrics: the port's own copy of ``evoke_tpu/evals/nlg.py``
(the port imports nothing of ``evoke_tpu``; a parity test holds the copy to
the original, to 1e-12). No Java, no external eval deps.

Capability parity: EVOKE modules/metrics/metrics.py:17-47 uses pycocoevalcap's
Bleu(4)/Meteor/Rouge/Cider. This module reimplements the same algorithms:

- ``bleu``: the COCO BleuScorer algorithm — corpus-level clipped n-gram
  precision with tiny/small smoothing, 'closest' effective reference length and
  the exp(1 - 1/ratio) brevity penalty.
- ``rouge_l``: COCO Rouge — mean per-sample LCS F-measure with beta=1.2.
- ``cider_d``: COCO Cider — tf-idf n-gram vectors (n=1..4) with count clipping
  and a gaussian length penalty (sigma=6), averaged over refs, x10.
- ``meteor_lite``: **approximation** of the METEOR Java jar (which needs
  WordNet data that may be absent): exact + suffix-stem matching, Fmean with
  alpha=0.9, chunk fragmentation penalty gamma=0.5, beta=3. Scores correlate
  with but do not bit-match METEOR 1.5; treat the METEOR column as indicative.

Inputs follow the reference convention: gts/res are dicts {id: [text]} (single
reference per image in EVOKE) or plain lists of strings.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple, Union

TextSet = Union[Dict[str, List[str]], Sequence[str]]


def _as_dicts(gts: TextSet, res: TextSet) -> Tuple[Dict, Dict]:
    if not isinstance(gts, dict):
        gts = {i: [g] for i, g in enumerate(gts)}
    if not isinstance(res, dict):
        res = {i: [r] for i, r in enumerate(res)}
    assert set(gts) == set(res), "gts/res id mismatch"
    return gts, res


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------- BLEU (COCO)

def bleu(gts: TextSet, res: TextSet, n: int = 4) -> Tuple[List[float], List[List[float]]]:
    """Corpus BLEU-1..n, the pycocoevalcap BleuScorer way (option='closest')."""
    gts, res = _as_dicts(gts, res)
    small, tiny = 1e-9, 1e-15
    correct = [0.0] * n
    guess = [0.0] * n
    testlen, reflen = 0, 0
    per_image: List[List[float]] = []

    stats = []
    for key in gts:
        hyp = res[key][0].split()
        refs = [r.split() for r in gts[key]]
        h_len = len(hyp)
        # closest reference length (ties -> shorter)
        r_len = min(sorted((abs(len(r) - h_len), len(r)) for r in refs))[1]
        testlen += h_len
        reflen += r_len
        img_correct, img_guess = [], []
        for k in range(1, n + 1):
            h_ng = _ngrams(hyp, k)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, k).items():
                    max_ref[ng] = max(max_ref[ng], c)
            c_k = sum(min(c, max_ref[ng]) for ng, c in h_ng.items())
            g_k = max(h_len - k + 1, 0)
            correct[k - 1] += c_k
            guess[k - 1] += g_k
            img_correct.append(c_k)
            img_guess.append(g_k)
        stats.append((img_correct, img_guess, h_len, r_len))

    def _scores(corr, gss, tl, rl):
        out = []
        p = 1.0
        ratio = tl / (rl + tiny)
        for k in range(n):
            p *= (corr[k] + tiny) / (gss[k] + small)
            s = p ** (1.0 / (k + 1))
            if ratio < 1.0:
                s *= math.exp(1 - 1 / (ratio + tiny))
            out.append(s)
        return out

    corpus = _scores(correct, guess, testlen, reflen)
    for img_correct, img_guess, h_len, r_len in stats:
        per_image.append(_scores(img_correct, img_guess, h_len, r_len))
    return corpus, per_image


# ------------------------------------------------------------- ROUGE-L (COCO)

def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(gts: TextSet, res: TextSet, beta: float = 1.2) -> Tuple[float, List[float]]:
    gts, res = _as_dicts(gts, res)
    scores = []
    for key in gts:
        hyp = res[key][0].split()
        best = 0.0
        for ref in gts[key]:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            if lcs == 0:
                f = 0.0
            else:
                prec = lcs / len(hyp) if hyp else 0.0
                rec = lcs / len(r) if r else 0.0
                f = ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec) \
                    if prec and rec else 0.0
            best = max(best, f)
        scores.append(best)
    return float(sum(scores) / max(len(scores), 1)), scores


# --------------------------------------------------------------- CIDEr (COCO)

def cider_d(gts: TextSet, res: TextSet, n: int = 4, sigma: float = 6.0
            ) -> Tuple[float, List[float]]:
    gts, res = _as_dicts(gts, res)
    # document frequency over reference sets
    doc_freq: Dict[tuple, float] = defaultdict(float)
    for key in gts:
        seen = set()
        for ref in gts[key]:
            toks = ref.split()
            for k in range(1, n + 1):
                seen |= set(_ngrams(toks, k).keys())
        for ng in seen:
            doc_freq[ng] += 1
    log_n_images = math.log(max(len(gts), 1))

    def vecs(tokens: List[str]):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = len(tokens)
        for k in range(1, n + 1):
            for ng, cnt in _ngrams(tokens, k).items():
                df = math.log(max(1.0, doc_freq[ng]))
                vec[k - 1][ng] = cnt * (log_n_images - df)
                norm[k - 1] += vec[k - 1][ng] ** 2
        return vec, [math.sqrt(x) for x in norm], length

    def sim(v_h, n_h, l_h, v_r, n_r, l_r):
        delta = float(l_h - l_r)
        out = []
        for k in range(n):
            val = 0.0
            for ng, w in v_h[k].items():
                val += min(w, v_r[k].get(ng, 0.0)) * v_r[k].get(ng, 0.0)
            if n_h[k] and n_r[k]:
                val /= (n_h[k] * n_r[k])
            val *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
            out.append(val)
        return out

    scores = []
    for key in gts:
        v_h, n_h, l_h = vecs(res[key][0].split())
        acc = [0.0] * n
        for ref in gts[key]:
            v_r, n_r, l_r = vecs(ref.split())
            s = sim(v_h, n_h, l_h, v_r, n_r, l_r)
            acc = [a + b for a, b in zip(acc, s)]
        score = sum(acc) / n / len(gts[key]) * 10.0
        scores.append(score)
    return float(sum(scores) / max(len(scores), 1)), scores


# ------------------------------------------------------------- METEOR (lite)

_SUFFIXES = ("ing", "ed", "es", "s", "ly", "ion", "tion")

# METEOR 1.5 English function words (content words get weight delta)
_FUNC_WORDS = set("""a an the and or but if of at by for with about against between into
through during before after above below to from up down in out on off over under again
further then once here there all any both each few more most other some such no nor not
only own same so than too very s t can will just don should now is are was were be been
being has have had do does did this that these those it its he she they them his her
their as""".split())


def _stem(w: str) -> str:
    for suf in _SUFFIXES:
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return w[: -len(suf)]
    return w


def _align(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """Greedy two-stage alignment (exact then stem); returns (#matches, #chunks)."""
    m_idx, _ = _align_weighted(hyp, ref)
    if not m_idx:
        return 0, 0
    return len(m_idx), _chunks(m_idx)


def _align_weighted(hyp: List[str], ref: List[str], w_stem: float = 0.6):
    """Greedy exact-then-stem alignment; returns (matches [(i, j, module_weight)], used)."""
    m_idx: List[Tuple[int, int, float]] = []
    used_ref = set()
    for stage, wt in (("exact", 1.0), ("stem", w_stem)):
        for i, hw in enumerate(hyp):
            if any(i == a for a, _, _ in m_idx):
                continue
            for j, rw in enumerate(ref):
                if j in used_ref:
                    continue
                ok = (hw == rw) if stage == "exact" else (_stem(hw) == _stem(rw))
                if ok:
                    m_idx.append((i, j, wt))
                    used_ref.add(j)
                    break
    m_idx.sort()
    return m_idx, used_ref


def _chunks(m_idx) -> int:
    chunks = 1
    for (i1, j1, _), (i2, j2, _) in zip(m_idx, m_idx[1:]):
        if not (i2 == i1 + 1 and j2 == j1 + 1):
            chunks += 1
    return chunks


def meteor_lite(gts: TextSet, res: TextSet, alpha: float = 0.85, beta: float = 0.2,
                gamma: float = 0.6, delta: float = 0.75, w_stem: float = 0.6
                ) -> Tuple[float, List[float]]:
    """METEOR 1.5 approximation: exact + stem modules (weight 1.0 / 0.6),
    content/function word weighting (delta), Fmean(alpha) with fragmentation
    penalty gamma * (chunks/m)^beta — everything except the WordNet synonym and
    paraphrase modules (unavailable offline). Validated within ~0.005 absolute
    of the Java jar's published values on the reference's 3852-report
    test_prediction.csv (tests/test_golden_metrics.py)."""
    gts, res = _as_dicts(gts, res)

    def wgt(w: str) -> float:
        return delta if w not in _FUNC_WORDS else 1.0 - delta

    scores = []
    for key in gts:
        hyp = res[key][0].split()
        best = 0.0
        for ref in gts[key]:
            r = ref.split()
            m_idx, _ = _align_weighted(hyp, r, w_stem)
            m = len(m_idx)
            if m == 0 or not hyp or not r:
                continue
            wh = sum(wgt(w) for w in hyp)
            wr = sum(wgt(w) for w in r)
            mh = sum(wt * wgt(hyp[i]) for i, _, wt in m_idx)
            mr = sum(wt * wgt(r[j]) for _, j, wt in m_idx)
            p = mh / wh if wh else 0.0
            q = mr / wr if wr else 0.0
            if p == 0.0 or q == 0.0:
                continue
            fmean = p * q / (alpha * p + (1 - alpha) * q)
            penalty = gamma * (_chunks(m_idx) / m) ** beta
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return float(sum(scores) / max(len(scores), 1)), scores


# ------------------------------------------------------------------ aggregate

_METEOR15 = None


def _meteor15():
    """Build the METEOR scorer once per process (stage probing hits disk).

    Exactness hooks (evals/meteor.py docstring): EVOKE_METEOR_JAR routes the
    column through the actual 1.5 jar (bit-exact with the reference's
    pycocoevalcap numbers); EVOKE_METEOR_PARAPHRASE / EVOKE_METEOR_DATA enable
    the paraphrase stage of the pure-Python scorer. With neither, the
    validated exact+stem default runs (±0.005 of the jar on the golden set).
    """
    global _METEOR15
    if _METEOR15 is None:
        import os

        from evoke_tpu_torch.evals.meteor import Meteor15, MeteorJar, default_paraphrase_path
        jar = os.environ.get("EVOKE_METEOR_JAR")
        if jar:
            try:
                _METEOR15 = MeteorJar(jar)
            except Exception as e:
                import sys
                print(f"[metrics] METEOR jar unavailable ({e}); "
                      "using the pure-Python scorer", file=sys.stderr)
        if _METEOR15 is None:
            _METEOR15 = Meteor15(paraphrase_path=default_paraphrase_path())
    return _METEOR15


def compute_nlg_scores(gts: TextSet, res: TextSet) -> Dict[str, float]:
    """The reference's compute_nlg_scores surface (metrics.py:17-47)."""
    out: Dict[str, float] = {}
    b, _ = bleu(gts, res, 4)
    for i, v in enumerate(b, 1):
        out[f"BLEU_{i}"] = v
    # full METEOR 1.5 scorer; with no wordnet/paraphrase data on disk its
    # exact+stem behavior is identical to meteor_lite (kept as fallback)
    try:
        out["METEOR"], _ = _meteor15()(gts, res)
    except Exception:
        out["METEOR"], _ = meteor_lite(gts, res)
    out["ROUGE_L"], _ = rouge_l(gts, res)
    out["CIDer"], _ = cider_d(gts, res)
    return out
