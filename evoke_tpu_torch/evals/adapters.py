"""Host-side adapters for heavy external CE metrics (off the training hot path):
the port's own copy of ``evoke_tpu/evals/adapters.py`` without
``radgraph_serialize`` (a factual-serialization hook no metric path calls;
ROADMAP A14).

Capability parity (SURVEY §2.6/§2.12): F1-RadGraph (AllenNLP/DyGIE), GREEN
(LLM judge), RadEntity NLI/exact (stanza + BERT-NLI), BERTScore. None of these
stacks runs on the card's kernels and none of their pip packages is a
dependency of the port, so each adapter (a) uses the package when installed,
(b) caches results keyed by text-pair hash (the reference re-instantiates
scorers every epoch — metrics.py:59-70 — which we explicitly avoid), and (c)
degrades loudly (raises MetricUnavailable with install guidance), never
silently returning zeros.

BERTScore is the exception: implemented natively below (greedy cosine matching
over BERT token embeddings) using torch-transformers at the eval edge.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class MetricUnavailable(RuntimeError):
    pass


class _DiskCache:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._mem: Dict[str, object] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                self._mem = json.load(f)

    @staticmethod
    def key(*texts: str) -> str:
        h = hashlib.sha256()
        for t in texts:
            h.update(t.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def get(self, key):
        return self._mem.get(key)

    def put(self, key, value):
        self._mem[key] = value
        if self.path:
            with open(self.path, "w") as f:
                json.dump(self._mem, f)


class F1RadGraphAdapter:
    """Wraps the `radgraph` pip package (F1RadGraph) with pair-level caching."""

    def __init__(self, model_path: str, reward_level: str = "partial",
                 cache_path: Optional[str] = None):
        try:
            from radgraph import F1RadGraph  # type: ignore
        except ImportError as e:
            raise MetricUnavailable(
                "F1-RadGraph needs the `radgraph` package (AllenNLP/DyGIE stack); "
                "install it on the eval host or configure a scoring service."
            ) from e
        self.scorer = F1RadGraph(reward_level=reward_level, model_path=model_path)
        self.cache = _DiskCache(cache_path)

    def __call__(self, hyps: Sequence[str], refs: Sequence[str]) -> Tuple[float, List[float]]:
        rewards: List[Optional[float]] = []
        todo_h, todo_r, todo_i = [], [], []
        for i, (h, r) in enumerate(zip(hyps, refs)):
            c = self.cache.get(self.cache.key(h, r))
            rewards.append(c)
            if c is None:
                todo_h.append(h)
                todo_r.append(r)
                todo_i.append(i)
        if todo_h:
            _, reward_list, _, _ = self.scorer(hyps=todo_h, refs=todo_r)
            for i, rw in zip(todo_i, reward_list):
                rewards[i] = float(rw)
                self.cache.put(self.cache.key(hyps[i], refs[i]), float(rw))
        vals = [float(r) for r in rewards]
        return sum(vals) / max(len(vals), 1), vals


class GreenAdapter:
    """GREEN LLM-judge (StanfordAIMI/GREEN-radllama2-7b) via transformers.

    The reference shells a 7B fp16 causal LM per (ref, pred) pair
    (green_score/green.py:25-222). Here generation is batched through the HF
    pipeline on the eval host; gated on the checkpoint being present locally
    (a host without network cannot download it).
    """

    def __init__(self, model_path: str, batch_size: int = 8, max_new_tokens: int = 256):
        if not os.path.isdir(model_path):
            raise MetricUnavailable(f"GREEN model not found at {model_path}")
        from transformers import AutoModelForCausalLM, AutoTokenizer  # noqa

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForCausalLM.from_pretrained(model_path)
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens

    @staticmethod
    def make_prompt(ref: str, hyp: str) -> str:
        """The GREEN judging prompt (green_score/utils.py:189 contract): six error
        categories (a)-(f), significant/insignificant sections, matched findings."""
        return (
            "Objective: Evaluate the accuracy of a candidate radiology report in "
            "comparison to a reference radiology report composed by expert "
            "radiologists.\n\n    Process Overview: You will be presented with:\n\n"
            "    1. The criteria for making a judgment.\n"
            "    2. The reference radiology report.\n"
            "    3. The candidate radiology report.\n"
            "    4. The desired format for your assessment.\n\n"
            "    1. Criteria for Judgment:\n\n    For each candidate report, determine:\n\n"
            "    The count of clinically significant errors.\n"
            "    The count of clinically insignificant errors.\n\n"
            "    Errors can fall into one of these categories:\n\n"
            "    a) False report of a finding in the candidate.\n"
            "    b) Missing a finding present in the reference.\n"
            "    c) Misidentification of a finding's anatomic location/position.\n"
            "    d) Misassessment of the severity of a finding.\n"
            "    e) Mentioning a comparison that isn't in the reference.\n"
            "    f) Omitting a comparison detailing a change from a prior study.\n"
            "    Note: Concentrate on the clinical findings rather than the report's "
            "writing style. Evaluate only the findings that appear in both reports.\n\n"
            f"    2. Reference Report:\n    {ref}\n\n"
            f"    3. Candidate Report:\n    {hyp}\n\n"
            "    4. Reporting Your Assessment:\n\n"
            "    Follow this specific format for your output, even if no errors are "
            "found:\n    ```\n    [Explanation]:\n    <Explanation>\n\n"
            "    [Clinically Significant Errors]:\n"
            "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; ...; "
            "<Error n>\n    ....\n"
            "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; ...; "
            "<Error n>\n\n    [Clinically Insignificant Errors]:\n"
            "    (a) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; ...; "
            "<Error n>\n    ....\n"
            "    (f) <Error Type>: <The number of errors>. <Error 1>; <Error 2>; ...; "
            "<Error n>\n\n    [Matched Findings]:\n"
            "    <The number of matched findings>. <Finding 1>; <Finding 2>; ...; "
            "<Finding n>\n    ```\n")

    def generate(self, hyps: Sequence[str], refs: Sequence[str]) -> List[str]:
        """Batched LLM judging: all (ref, hyp) prompts tokenized together per
        batch (left padding) and generated in one call — the reference loops one
        pair per generate() (green.py:164-172, its own measured pain point)."""
        import torch

        self.tokenizer.padding_side = "left"
        if self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = self.tokenizer.eos_token
        responses = []
        for s in range(0, len(hyps), self.batch_size):
            prompts = [self.make_prompt(r, h)
                       for h, r in zip(hyps[s:s + self.batch_size], refs[s:s + self.batch_size])]
            enc = self.tokenizer(prompts, return_tensors="pt", padding=True)
            with torch.no_grad():
                out = self.model.generate(**enc, max_new_tokens=self.max_new_tokens)
            out = out[:, enc["input_ids"].shape[1]:]
            responses += [self.clean_response(t) for t in
                          self.tokenizer.batch_decode(out, skip_special_tokens=False)]
        return responses

    def __call__(self, hyps: Sequence[str], refs: Sequence[str]) -> float:
        return self.score(hyps, refs)["green_mean"]

    def score(self, hyps: Sequence[str], refs: Sequence[str]) -> Dict[str, object]:
        """Full GREEN results (green_score/green.py:188-260,418-468): per-pair
        scores, mean/std, the 6 significant-error subcategory counts + matched
        findings per pair, and per-subcategory accuracy (fraction error-free)."""
        responses = self.generate(hyps, refs)
        return self.summarize(responses)

    @classmethod
    def summarize(cls, responses: Sequence[str],
                  embed_fn=None) -> Dict[str, object]:
        """Aggregate GREEN results; with ``embed_fn`` (sentences -> [N, D]
        embeddings) also computes the reference's representative-sentence
        summary per significant-error subcategory (green.py:397-415)."""
        scores = [cls.compute_green(r) for r in responses]
        counts = [cls.error_counts(r) for r in responses]
        n = max(len(responses), 1)
        valid = [s for s in scores if s is not None]
        mean = sum(valid) / max(len(valid), 1)
        std = (sum((s - mean) ** 2 for s in valid) / max(len(valid), 1)) ** 0.5
        accuracies = {
            sub: sum(1 for c in counts if c[i] == 0) / n
            for i, sub in enumerate(cls.SUB_CATEGORIES)}
        out = {"green_mean": mean, "green_std": std, "scores": scores,
               "error_counts": counts, "accuracies": accuracies,
               "summary": (f"[Summary]: Green average {mean} and standard "
                           f"variation {std}")}
        if embed_fn is not None:
            reps = cls.representative_sentences(responses, embed_fn)
            out["representative_sentences"] = reps
            lines = [f"[Summary]: Green average {mean} and standard variation "
                     f"{std} \n [Clinically Significant Errors Analyses]: "
                     "<accuracy>. <representative error>"]
            for sub in cls.SUB_CATEGORIES:
                lines.append(f"{sub}: {accuracies[sub]}. \n {reps[sub]}")
            out["summary"] = " \n\n ".join(lines)
        return out

    # ---- representative-sentence summary (green_score/utils.py:15-109) ----

    @classmethod
    def parse_error_sentences(cls, response: str, category: str) -> Dict[str, List[str]]:
        """Per-subcategory error sentences of one response (green.py:296-347):
        the text after the count, split on ';'."""
        import re

        out: Dict[str, List[str]] = {sub: [] for sub in cls.SUB_CATEGORIES}
        m = re.search(rf"\[{category}\]:\s*(.*?)(?:\n\s*\n|\Z)", response, re.DOTALL)
        if not m or m.group(1).startswith("No"):
            return out
        matches = sorted(re.findall(r"\([a-f]\) .*", m.group(1)))
        subs = cls.SUB_CATEGORIES
        if not matches:  # numeric template variant
            matches = sorted(re.findall(r"\([1-6]\) .*", m.group(1)))
            subs = [f"({i}) " for i in range(1, 7)]
        for pos, sub in enumerate(subs):
            for match in matches:
                if match.startswith(sub.split(" ", 1)[0] + " "):
                    out[cls.SUB_CATEGORIES[pos]] = (
                        match.rsplit(":", 1)[-1].split(".", 1)[-1].split(";"))
        return out

    @classmethod
    def representative_sentences(cls, responses: Sequence[str],
                                 embed_fn) -> Dict[str, Optional[str]]:
        """Most-representative significant-error sentence per subcategory: pool
        sentences across responses, k-means-cluster their embeddings (k chosen
        by silhouette binary search), take the largest cluster's sentence
        closest to its center (green.py:353-369, utils.py:15-109)."""
        pooled: Dict[str, List[str]] = {sub: [] for sub in cls.SUB_CATEGORIES}
        for r in responses:
            for sub, sents in cls.parse_error_sentences(r, cls.CATEGORIES[0]).items():
                pooled[sub].extend(s for s in sents if s.strip())
        out: Dict[str, Optional[str]] = {}
        for sub, sentences in pooled.items():
            if not sentences:
                out[sub] = None
                continue
            emb = np.asarray(embed_fn(sentences), np.float64)
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
            out[sub] = cls._largest_cluster_representative(emb, sentences)
        return out

    @staticmethod
    def _kmeans(data: np.ndarray, k: int, seed: int = 42, iters: int = 50):
        """Deterministic k-means (k-means++ init) in plain numpy — the eval
        edge needs no sklearn. Returns (labels, centers)."""
        rng = np.random.default_rng(seed)
        centers = [data[int(rng.integers(len(data)))]]
        for _ in range(1, k):
            d2 = np.min(((data[:, None, :] - np.stack(centers)[None]) ** 2
                         ).sum(-1), axis=1)
            total = d2.sum()
            probs = d2 / total if total > 0 else np.full(len(data), 1.0 / len(data))
            centers.append(data[int(rng.choice(len(data), p=probs))])
        centers = np.stack(centers)
        labels = np.zeros(len(data), np.int64)
        for _ in range(iters):
            d = ((data[:, None, :] - centers[None]) ** 2).sum(-1)
            new_labels = d.argmin(1)
            if (new_labels == labels).all() and _ > 0:
                break
            labels = new_labels
            for j in range(k):
                pts = data[labels == j]
                if len(pts):
                    centers[j] = pts.mean(0)
        return labels, centers

    @staticmethod
    def _silhouette(data: np.ndarray, labels: np.ndarray) -> float:
        """Mean silhouette coefficient (euclidean), plain numpy."""
        d = np.sqrt(((data[:, None, :] - data[None]) ** 2).sum(-1))
        uniq = np.unique(labels)
        scores = []
        for i in range(len(data)):
            same = (labels == labels[i])
            n_same = same.sum() - 1
            if n_same == 0:
                scores.append(0.0)
                continue
            a = d[i][same].sum() / n_same
            b = min(d[i][labels == c].mean() for c in uniq if c != labels[i])
            scores.append((b - a) / max(a, b) if max(a, b) > 0 else 0.0)
        return float(np.mean(scores))

    @classmethod
    def _largest_cluster_representative(cls, emb: np.ndarray,
                                        sentences: List[str]) -> str:
        """Binary-search k on silhouette (utils.py:76-109), largest cluster,
        sentence nearest (cosine) to its center (utils.py:15-46)."""
        if len(sentences) == 1:
            return sentences[0]
        best_labels, best_centers = cls._kmeans(emb, 1)
        best_score, lo, hi = -1.0, 0, len(sentences)
        while lo <= hi:
            mid = (lo + hi) // 2
            if mid < 2:
                break
            if mid >= len(sentences):
                hi = mid - 1
                continue
            labels, centers = cls._kmeans(emb, mid)
            if len(np.unique(labels)) < 2:
                hi = mid - 1
                continue
            score = cls._silhouette(emb, labels)
            if score > best_score:
                best_score, best_labels, best_centers = score, labels, centers
                lo = mid + 1
            else:
                hi = mid - 1
        sizes = np.bincount(best_labels)
        big = int(np.argmax(sizes))
        member_ids = np.where(best_labels == big)[0]
        center = best_centers[big]
        cn = center / max(np.linalg.norm(center), 1e-12)
        cos_d = 1.0 - emb[member_ids] @ cn
        return sentences[int(member_ids[int(np.argmin(cos_d))])]

    @staticmethod
    def sentence_embed_fn(model_path: str):
        """Gated sentence-transformers embedder (the reference's
        paraphrase-mpnet-base-v2, utils.py:62-66); raises MetricUnavailable
        when the package or local checkpoint is absent."""
        try:
            from sentence_transformers import SentenceTransformer  # type: ignore
        except ImportError as e:
            raise MetricUnavailable(f"sentence-transformers not installed: {e}")
        if not os.path.isdir(model_path):
            raise MetricUnavailable(f"sentence embedder not found at {model_path}")
        model = SentenceTransformer(model_name_or_path=model_path,
                                    local_files_only=True)
        return lambda sentences: model.encode(sentences)

    # ---- response parsing (green_score contract) ----

    CATEGORIES = ["Clinically Significant Errors", "Clinically Insignificant Errors",
                  "Matched Findings"]
    SUB_CATEGORIES = [
        "(a) False report of a finding in the candidate",
        "(b) Missing a finding present in the reference",
        "(c) Misidentification of a finding's anatomic location/position",
        "(d) Misassessment of the severity of a finding",
        "(e) Mentioning a comparison that isn't in the reference",
        "(f) Omitting a comparison detailing a change from a prior study",
    ]

    @staticmethod
    def clean_response(response: str) -> str:
        """green_score/utils.py:174-186 contract."""
        if "[Explanation]:" in response:
            if "<|assistant|>" in response:
                response = response.split("<|assistant|>")[-1]
            response = response.split("[Explanation]:")[-1]
        if "<|assistant|>" in response:
            response = response.split("<|assistant|>")[-1]
        return response.replace("</s>", "").replace("<unk>", "")

    @classmethod
    def parse_error_counts(cls, text: str, category: str) -> Tuple[int, List[int]]:
        """(green.py:242-295): -> (sum, [six subcategory counts]). For
        'Matched Findings' the sum is the leading integer of the block."""
        import re

        pattern = rf"\[{category}\]:\s*(.*?)(?:\n\s*\n|\Z)"
        m = re.search(pattern, text, re.DOTALL)
        sub_counts = [0] * 6
        if not m or m.group(1).startswith("No"):
            return 0, sub_counts
        block = m.group(1)
        if category == "Matched Findings":
            counts = re.findall(r"^\b\d+\b(?=\.)", block)
            return (int(counts[0]) if counts else 0), sub_counts
        subs = [s.split(" ", 1)[0] + " " for s in cls.SUB_CATEGORIES]
        matches = sorted(re.findall(r"\([a-f]\) .*", block))
        if not matches:  # numeric template variant
            matches = sorted(re.findall(r"\([1-6]\) .*", block))
            subs = [f"({i}) " for i in range(1, 7)]
        for pos, sub in enumerate(subs):
            for match in matches:
                if match.startswith(sub):
                    count = re.findall(r"(?<=: )\b\d+\b(?=\.)", match)
                    if count:
                        sub_counts[pos] = int(count[0])
        return sum(sub_counts), sub_counts

    @classmethod
    def error_counts(cls, response: str) -> List[int]:
        """[six significant-error counts, matched findings] (green.py:216-220)."""
        _, sig = cls.parse_error_counts(response, cls.CATEGORIES[0])
        matched, _ = cls.parse_error_counts(response, cls.CATEGORIES[2])
        return sig + [matched]

    @classmethod
    def compute_green(cls, response: str) -> float:
        """green = matched / (matched + sum(sig_errors)); 0 when nothing matched
        (green.py:222-240). Insignificant errors do not count against the score."""
        sig_sum, sig = cls.parse_error_counts(response, cls.CATEGORIES[0])
        matched, _ = cls.parse_error_counts(response, cls.CATEGORIES[2])
        if matched == 0:
            return 0.0
        return matched / (matched + sum(sig))

    # back-compat alias (round-1 surface)
    parse_green = compute_green


class RadEntityAdapter:
    """RadEntity exact/NLI entity match (stanza radiology NER), gated."""

    def __init__(self):
        try:
            import stanza  # type: ignore # noqa
        except ImportError as e:
            raise MetricUnavailable("RadEntity metrics need the `stanza` package") from e
        import stanza

        self.nlp = stanza.Pipeline("en", package="radiology", processors={"ner": "radiology"})

    def entities(self, text: str) -> List[str]:
        doc = self.nlp(text)
        return [ent.text.lower() for ent in doc.entities]

    def exact_match_f1(self, hyps: Sequence[str], refs: Sequence[str]) -> float:
        f1s = []
        for h, r in zip(hyps, refs):
            he, re_ = set(self.entities(h)), set(self.entities(r))
            if not he and not re_:
                f1s.append(1.0)
                continue
            inter = len(he & re_)
            p = inter / max(len(he), 1)
            q = inter / max(len(re_), 1)
            f1s.append(0.0 if p + q == 0 else 2 * p * q / (p + q))
        return sum(f1s) / max(len(f1s), 1)


class NLIScorer:
    """Sentence-level NLI scoring for the RadEntityNLI metric
    (EVOKE modules/metrics/RadEntityNLI/nli.py contract): an HF
    sequence-classification NLI model scores hypothesis sentences against
    reference sentences; an entity match is NLI-weighted by the best
    entailment probability of its containing sentence. Gated on a local
    checkpoint (e.g. a BERT-NLI fine-tune with entailment as class index 0/2
    per its config.id2label)."""

    def __init__(self, model_path: str, batch_size: int = 32):
        if not os.path.isdir(model_path):
            raise MetricUnavailable(f"NLI model not found at {model_path}")
        from transformers import (AutoModelForSequenceClassification,  # noqa
                                  AutoTokenizer)

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForSequenceClassification.from_pretrained(model_path)
        self.model.eval()
        id2label = getattr(self.model.config, "id2label", {}) or {}
        self.entail_idx = next(
            (int(i) for i, lbl in id2label.items()
             if "entail" in str(lbl).lower()), 0)
        self.batch_size = batch_size

    def entailment_probs(self, premises: Sequence[str], hypotheses: Sequence[str]
                         ) -> List[float]:
        import torch

        out: List[float] = []
        for s in range(0, len(premises), self.batch_size):
            enc = self.tokenizer(list(premises[s:s + self.batch_size]),
                                 list(hypotheses[s:s + self.batch_size]),
                                 return_tensors="pt", padding=True, truncation=True,
                                 max_length=256)
            with torch.no_grad():
                logits = self.model(**enc).logits
            probs = torch.softmax(logits, dim=-1)[:, self.entail_idx]
            out.extend(probs.tolist())
        return out

    def label(self, premise: str, hypothesis: str) -> str:
        """Argmax NLI label name ('entailment'/'neutral'/'contradiction')."""
        import torch

        enc = self.tokenizer([premise], [hypothesis], return_tensors="pt",
                             padding=True, truncation=True, max_length=256)
        with torch.no_grad():
            logits = self.model(**enc).logits
        idx = int(torch.argmax(logits, dim=-1)[0])
        id2label = getattr(self.model.config, "id2label", {}) or {}
        return str(id2label.get(idx, id2label.get(str(idx), idx))).lower()


class RadEntityNLIScorer:
    """NLI-weighted entity-match F1 — the assembled RadEntityNLI metric
    (EVOKE modules/metrics/RadEntityNLI/RadEntityNLI.py:48-127 algorithm):

    Per report pair: split into sentences; extract radiology entities per
    sentence; for each hyp sentence with entities, find the most similar ref
    sentence (sentence-level BERTScore-F argmax) and NLI-label the pair;
    precision counts = +1 sentence bonus if entailment, +1 per entity present
    in the reference's entity set unless contradiction; recall mirrors with
    roles swapped; report F1 = harmonic mean; corpus score = mean over reports.

    Components are injectable for testing: ``ner_fn(text) -> [(sentence,
    [entities])]``, ``sim_fn(hyp_sents, ref_sents) -> [[f]]``,
    ``nli_fn(premise, hypothesis) -> 'entailment'|'neutral'|'contradiction'``.
    Defaults: stanza radiology NER (RadEntityAdapter), native bertscore
    embeddings, and NLIScorer with an argmax label head.
    """

    def __init__(self, ner_fn=None, sim_fn=None, nli_fn=None,
                 nli_model_path: Optional[str] = None,
                 bertscore_model_path: Optional[str] = None):
        if ner_fn is None:
            adapter = RadEntityAdapter()

            def ner_fn(text):
                doc = adapter.nlp(text)
                return [(" ".join(t.text for t in s.tokens),
                         [e.text.lower() for e in s.ents]) for s in doc.sentences]

        if sim_fn is None:
            if not bertscore_model_path:
                raise MetricUnavailable("RadEntityNLI needs bertscore_model_path")
            sim_fn = _sentence_bertscore_matrix_fn(bertscore_model_path)
        if nli_fn is None:
            if not nli_model_path:
                raise MetricUnavailable("RadEntityNLI needs nli_model_path")
            scorer = NLIScorer(nli_model_path)

            def nli_fn(premise, hypothesis):
                return scorer.label(premise, hypothesis)

        self.ner_fn, self.sim_fn, self.nli_fn = ner_fn, sim_fn, nli_fn

    def _directional(self, from_sents, from_ents, to_ents_flat, sim_rows, to_sents):
        match = total = 0
        for sent, ents, sims in zip(from_sents, from_ents, sim_rows):
            if not ents:
                continue
            best = max(range(len(sims)), key=lambda j: sims[j])
            label = self.nli_fn(sent, to_sents[best])
            if label == "entailment":
                match += 1
            for e in ents:
                total += 1
                if label == "contradiction":
                    continue
                if e in to_ents_flat:
                    match += 1
        return match, total

    def score_pair(self, hyp: str, ref: str) -> Optional[float]:
        h = self.ner_fn(hyp)
        r = self.ner_fn(ref)
        if not h or not r:
            return None
        h_sents, h_ents = [s for s, _ in h], [e for _, e in h]
        r_sents, r_ents = [s for s, _ in r], [e for _, e in r]
        sims = self.sim_fn(h_sents, r_sents)          # [len(h), len(r)]
        sims_t = [[sims[i][j] for i in range(len(h_sents))] for j in range(len(r_sents))]
        mp, tp = self._directional(h_sents, h_ents,
                                   [e for es in r_ents for e in es], sims, r_sents)
        mr, tr = self._directional(r_sents, r_ents,
                                   [e for es in h_ents for e in es], sims_t, h_sents)
        p = mp / tp if tp > 0 else 0.0
        r_ = mr / tr if tr > 0 else 0.0
        return 2 * p * r_ / (p + r_) if p > 0.0 and r_ > 0.0 else 0.0

    def __call__(self, hyps: Sequence[str], refs: Sequence[str]
                 ) -> Tuple[float, List[float]]:
        scores = [s for s in (self.score_pair(h, r) for h, r in zip(hyps, refs))
                  if s is not None]
        return sum(scores) / max(len(scores), 1), scores


def _sentence_bertscore_matrix_fn(model_path: str):
    """-> sim_fn(hyp_sents, ref_sents) -> [[BERTScore-F]] (all pairs)."""

    def sim_fn(hyp_sents, ref_sents):
        pairs_h, pairs_r = [], []
        for h in hyp_sents:
            for r in ref_sents:
                pairs_h.append(h)
                pairs_r.append(r)
        flat = bertscore_f1s(pairs_h, pairs_r, model_path)
        n = len(ref_sents)
        return [flat[i * n:(i + 1) * n] for i in range(len(hyp_sents))]

    return sim_fn


_BERTSCORE_CACHE: Dict[str, tuple] = {}


def bertscore_f1s(hyps: Sequence[str], refs: Sequence[str], model_path: str,
                  num_layers: int = 5, batch_size: int = 32) -> List[float]:
    """Per-pair native BERTScore-F1: greedy cosine matching over
    layer-`num_layers` BERT token embeddings (the bert_score package's core
    algorithm, no baselines/idf; reference modules/bertscore.py used distilbert
    rescaled — rescaling is affine so rankings/argmax are unchanged)."""
    if not os.path.isdir(model_path):
        raise MetricUnavailable(f"BERTScore model not found at {model_path}")
    import torch
    from transformers import AutoModel, AutoTokenizer

    if model_path not in _BERTSCORE_CACHE:
        tok = AutoTokenizer.from_pretrained(model_path)
        model = AutoModel.from_pretrained(model_path, output_hidden_states=True)
        model.eval()
        _BERTSCORE_CACHE[model_path] = (tok, model)
    tok, model = _BERTSCORE_CACHE[model_path]

    def embed(texts):
        enc = tok(list(texts), return_tensors="pt", padding=True, truncation=True,
                  max_length=256)
        with torch.no_grad():
            out = model(**enc)
        h = out.hidden_states[num_layers]
        h = torch.nn.functional.normalize(h, dim=-1)
        return h, enc["attention_mask"].bool()

    f1s: List[float] = []
    for start in range(0, len(hyps), batch_size):
        hh, rr = hyps[start:start + batch_size], refs[start:start + batch_size]
        eh, mh = embed(hh)
        er, mr = embed(rr)
        for i in range(len(hh)):
            a = eh[i][mh[i]]
            b = er[i][mr[i]]
            sim = a @ b.T
            p = sim.max(dim=1).values.mean().item()
            r = sim.max(dim=0).values.mean().item()
            f1s.append(0.0 if p + r == 0 else 2 * p * r / (p + r))
    return f1s


def bertscore(hyps: Sequence[str], refs: Sequence[str], model_path: str,
              num_layers: int = 5, batch_size: int = 32) -> float:
    f1s = bertscore_f1s(hyps, refs, model_path, num_layers, batch_size)
    return sum(f1s) / max(len(f1s), 1)
