"""METEOR 1.5 (Denkowski & Lavie 2014) — full scoring algorithm, pure Python:
the port's own copy of ``evoke_tpu/evals/meteor.py`` (same stages, defaults
and environment hooks; a parity test holds it to the original).

Replaces the reference's pycocoevalcap Java jar (EVOKE
modules/metrics/metrics.py:17-47) at the eval edge. English defaults match the
jar (`-l en -norm`): module weights exact 1.0 / stem 0.6 / synonym 0.8 /
paraphrase 0.6; alpha=0.85, beta=0.2, gamma=0.6, delta=0.75.

Data-gated stages (the jar ships data files that may be absent locally):
- stem: nltk Snowball (Porter2 — METEOR 1.5's stemmer) when nltk is
  importable, else a suffix-stripping fallback;
- synonym: WordNet synsets when the nltk wordnet corpus is on disk;
- paraphrase: a word-level paraphrase table loaded from ``paraphrase_path``
  (one 'phrase ||| phrase' pair per line, METEOR data format; plain text or
  gzip).

When synonym/paraphrase data is absent the scorer degrades to exact+stem,
which lands within ~0.005 absolute of the jar's published values on the
reference's 3852-report test set (tests/test_golden_metrics.py).

Exactness hooks on an eval host (activate via environment, no code change):
- ``EVOKE_METEOR_JAR=/path/to/meteor-1.5.jar`` — score with the actual jar
  through its ``-stdio`` protocol (bit-exact with the reference's
  pycocoevalcap numbers, modules/metrics/metrics.py:17-47); needs ``java``.
- ``EVOKE_METEOR_PARAPHRASE=/path/to/paraphrase-en.gz`` (or
  ``EVOKE_METEOR_DATA=<dir>`` containing ``paraphrase-en.gz``/``.txt``) —
  enable the paraphrase stage of the pure-Python scorer.
- WordNet: point ``NLTK_DATA`` at a directory containing ``corpora/wordnet``
  to enable the synonym stage.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from evoke_tpu_torch.evals.nlg import _FUNC_WORDS, _as_dicts, _stem as _suffix_stem

TextSet = Dict[str, List[str]]


def _snowball():
    try:
        from nltk.stem.snowball import SnowballStemmer

        return SnowballStemmer("english").stem
    except Exception:
        return _suffix_stem


def _wordnet_synsets() -> Optional[Callable[[str], frozenset]]:
    """-> word -> frozenset of synset names (incl. the word itself), or None
    when the wordnet corpus is not on disk."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("test")  # force the LazyCorpusLoader to hit disk
    except Exception:
        return None

    cache: Dict[str, frozenset] = {}

    def synsets(word: str) -> frozenset:
        got = cache.get(word)
        if got is None:
            got = frozenset(s.name() for s in wordnet.synsets(word)) | {word}
            cache[word] = got
        return got

    return synsets


class Meteor15:
    """Callable scorer: ``Meteor15()(gts, res) -> (mean, per_report_scores)``."""

    def __init__(self, alpha: float = 0.85, beta: float = 0.2, gamma: float = 0.6,
                 delta: float = 0.75, w_exact: float = 1.0, w_stem: float = 0.6,
                 w_syn: float = 0.8, w_para: float = 0.6,
                 paraphrase_path: Optional[str] = None,
                 stemmer: str = "suffix", chunk_preference: bool = False):
        """Defaults measured against the jar's published value on the reference's
        3852-report test set (published 0.16671): suffix stem + greedy-first
        alignment gives 0.17166; Snowball and the adjacency chunk preference
        each push FURTHER from the jar (0.17779 combined), so both are opt-in
        (stemmer='snowball', chunk_preference=True)."""
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.stem = _snowball() if stemmer == "snowball" else _suffix_stem
        self.chunk_preference = chunk_preference
        self.synsets = _wordnet_synsets()
        self.paraphrases = self._load_paraphrases(paraphrase_path)
        self.stages: List[Tuple[str, float]] = [("exact", w_exact), ("stem", w_stem)]
        if self.synsets is not None:
            self.stages.append(("synonym", w_syn))
        if self.paraphrases is not None:
            self.stages.append(("paraphrase", w_para))

    @staticmethod
    def _load_paraphrases(path: Optional[str]) -> Optional[Dict[str, set]]:
        if not path or not os.path.exists(path):
            return None
        import gzip

        opener = gzip.open if path.endswith(".gz") else open
        table: Dict[str, set] = {}
        with opener(path, "rt") as f:
            for line in f:
                parts = [p.strip() for p in line.split("|||")]
                if len(parts) < 2 or not parts[0] or not parts[1]:
                    continue
                table.setdefault(parts[0], set()).add(parts[1])
                table.setdefault(parts[1], set()).add(parts[0])
        return table or None

    # ---- matching ----

    def _match(self, stage: str, hw: str, rw: str) -> bool:
        if stage == "exact":
            return hw == rw
        if stage == "stem":
            return self.stem(hw) == self.stem(rw)
        if stage == "synonym":
            # share any WordNet synset ({word} is in its own set, so identical
            # surface forms also pass; distinct words need a true shared synset)
            return bool(self.synsets(hw) & self.synsets(rw))
        return rw in self.paraphrases.get(hw, ()) or hw == rw  # paraphrase

    def _align(self, hyp: Sequence[str], ref: Sequence[str]
               ) -> List[Tuple[int, int, float]]:
        """Stage-priority one-to-one alignment; within a stage, prefer the
        reference position that continues a contiguous run (fewer chunks —
        the jar's beam aligner's main tie-break)."""
        matches: Dict[int, Tuple[int, float]] = {}   # hyp idx -> (ref idx, weight)
        used_ref: set = set()
        for stage, wt in self.stages:
            prev_j = -2
            for i, hw in enumerate(hyp):
                if i in matches:
                    prev_j = matches[i][0]
                    continue
                candidates = [j for j, rw in enumerate(ref)
                              if j not in used_ref and self._match(stage, hw, rw)]
                if not candidates:
                    prev_j = -2
                    continue
                # optional adjacency preference: continue the current run
                j = (next((c for c in candidates if c == prev_j + 1), candidates[0])
                     if self.chunk_preference else candidates[0])
                matches[i] = (j, wt)
                used_ref.add(j)
                prev_j = j
        return sorted((i, j, wt) for i, (j, wt) in matches.items())

    @staticmethod
    def _chunks(m_idx: List[Tuple[int, int, float]]) -> int:
        chunks = 1
        for (i1, j1, _), (i2, j2, _) in zip(m_idx, m_idx[1:]):
            if not (i2 == i1 + 1 and j2 == j1 + 1):
                chunks += 1
        return chunks

    # ---- scoring ----

    def _wgt(self, w: str) -> float:
        return self.delta if w not in _FUNC_WORDS else 1.0 - self.delta

    def score_pair(self, hyp: Sequence[str], ref: Sequence[str]) -> float:
        if not hyp or not ref:
            return 0.0
        m_idx = self._align(hyp, ref)
        m = len(m_idx)
        if m == 0:
            return 0.0
        wh = sum(self._wgt(w) for w in hyp)
        wr = sum(self._wgt(w) for w in ref)
        mh = sum(wt * self._wgt(hyp[i]) for i, _, wt in m_idx)
        mr = sum(wt * self._wgt(ref[j]) for _, j, wt in m_idx)
        p = mh / wh if wh else 0.0
        r = mr / wr if wr else 0.0
        if p == 0.0 or r == 0.0:
            return 0.0
        fmean = p * r / (self.alpha * p + (1 - self.alpha) * r)
        penalty = self.gamma * (self._chunks(m_idx) / m) ** self.beta
        return fmean * (1 - penalty)

    def __call__(self, gts: TextSet, res: TextSet) -> Tuple[float, List[float]]:
        gts, res = _as_dicts(gts, res)
        scores = []
        for key in gts:
            hyp = res[key][0].split()
            scores.append(max((self.score_pair(hyp, ref.split()) for ref in gts[key]),
                              default=0.0))
        return float(sum(scores) / max(len(scores), 1)), scores


def meteor(gts: TextSet, res: TextSet, paraphrase_path: Optional[str] = None
           ) -> Tuple[float, List[float]]:
    return Meteor15(paraphrase_path=paraphrase_path)(gts, res)


def default_paraphrase_path() -> Optional[str]:
    """Resolve the paraphrase-table path from the environment (module
    docstring's file-layout contract); None when no data is supplied."""
    p = os.environ.get("EVOKE_METEOR_PARAPHRASE")
    if p and os.path.exists(p):
        return p
    root = os.environ.get("EVOKE_METEOR_DATA")
    if root:
        for name in ("paraphrase-en.gz", "paraphrase-en.txt", "paraphrase.txt"):
            cand = os.path.join(root, name)
            if os.path.exists(cand):
                return cand
    return None


class MeteorJar:
    """Bit-exact METEOR via the actual 1.5 jar's ``-stdio`` protocol.

    The reference scores METEOR with this jar through pycocoevalcap
    (modules/metrics/metrics.py:17-47); on an eval host with Java + the jar,
    setting ``EVOKE_METEOR_JAR`` routes the METEOR column through it so the
    number is exactly comparable to the published CSVs. The pure-Python
    ``Meteor15`` stays the offline default.
    """

    def __init__(self, jar_path: str, language: str = "en"):
        import shutil
        import subprocess
        import threading

        if shutil.which("java") is None:
            raise RuntimeError("MeteorJar: no `java` on PATH")
        if not os.path.exists(jar_path):
            raise RuntimeError(f"MeteorJar: jar not found at {jar_path}")
        self._lock = threading.Lock()
        self._proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", os.path.basename(jar_path), "-", "-",
             "-stdio", "-l", language, "-norm"],
            cwd=os.path.dirname(os.path.abspath(jar_path)) or ".",
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)

    def _io(self, line: str) -> str:
        assert self._proc.stdin and self._proc.stdout
        self._proc.stdin.write(line.replace("\n", " ") + "\n")
        self._proc.stdin.flush()
        return self._proc.stdout.readline().strip()

    def __call__(self, gts: TextSet, res: TextSet) -> Tuple[float, List[float]]:
        gts, res = _as_dicts(gts, res)
        with self._lock:
            stats = []
            for key in gts:
                refs = " ||| ".join(r.replace("|||", " ") for r in gts[key])
                hyp = res[key][0].replace("|||", " ")
                stats.append(self._io(f"SCORE ||| {refs} ||| {hyp}"))
            assert self._proc.stdin and self._proc.stdout
            self._proc.stdin.write("EVAL ||| " + " ||| ".join(stats) + "\n")
            self._proc.stdin.flush()
            scores = [float(self._proc.stdout.readline().strip())
                      for _ in range(len(stats))]
            final = float(self._proc.stdout.readline().strip())
        return final, scores

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self._proc.stdin.close()  # type: ignore[union-attr]
                self._proc.wait(timeout=5)
            except Exception:
                self._proc.kill()

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
