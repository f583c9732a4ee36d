"""Factual serialization: report -> ordered clinical keyword sentences.

Capability parity: EVOKE modules/factual_serialization.py — run RadGraph NER
over reports and turn entity graphs into ordered ``core_findings`` keyword
lists; also extract the indication-section serialization. The RadGraph
AllenNLP/DyGIE stack is a host-side dependency (SURVEY §2.12) exposed through
evals/adapters.py when installed; this module provides the orchestration plus a
dependency-free heuristic extractor so the pipeline runs end-to-end without it
(sentence-wise stopword-filtered noun-ish phrases — clearly marked lower
fidelity than RadGraph).
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional

from evoke_tpu_torch.tools.section_parser import extract_section

_STOPWORDS = set("""a an and are as at be been by for from has have in is it its of on
or that the there this to was were with within without seen noted nota note
compared comparison prior stable unchanged again redemonstrated demonstrates
demonstrated evidence visualized otherwise grossly status please clinical
correlation recommend recommended""".split())

_NEGATION = ("no ", "without ", "free of ", "negative for ")

_SENT_SPLIT = re.compile(r"(?<=[.?!])\s+")


def heuristic_core_findings(report: str, max_keywords_per_sentence: int = 6
                            ) -> List[str]:
    """Dependency-free factual serialization: per sentence, keep negation cues +
    content words (stopword-filtered), joined in report order."""
    out: List[str] = []
    for sent in _SENT_SPLIT.split(report.strip()):
        s = sent.strip().lower().rstrip(".")
        if not s:
            continue
        neg = any(s.startswith(n) or f" {n}" in f" {s} " for n in _NEGATION)
        words = re.findall(r"[a-z][a-z\-]+", s)
        content = [w for w in words if w not in _STOPWORDS][:max_keywords_per_sentence]
        if not content:
            continue
        phrase = " ".join(content)
        out.append(f"no {phrase}" if neg and not phrase.startswith("no ") else phrase)
    return out


# ---------------------------------------------------------------------------
# RadGraph entity-graph -> ordered core_findings (reference-faithful pipeline,
# modules/factual_serialization.py:197-286 + :577-608)
# ---------------------------------------------------------------------------

USELESS_FINDINGS = {"It", "it", "otherwise", "They", "These", "This"}
_PUNCT_ENTITIES = set(",:;!()*&-_?")
# spacing normalization applied to reports with no NER output
# (factual_serialization.py:630-631)
_SPACING_RE = re.compile(r"(?<!\d)(?=[/,;,:,.,!?()])|(?<=[/,;,:,.,!?()])(?!\d)|\n")


def resolve_overlapping_entities(entities: List[tuple], tokens: List[str]
                                 ) -> List[tuple]:
    """Overlap resolution (``preprocessing_entities``, reference :577-608):
    keep at most one of two overlapping spans — prefer spans that do not cross
    a sentence dot; among same-kind spans, prefer the longer."""
    out: List[tuple] = []
    head_end = -1
    for ent in entities:
        start, end, label = ent[0], ent[1], str(ent[2]).strip()
        if start > end:
            continue
        if start <= head_end and out:
            ps, pe = out[-1][0], out[-1][1]
            prev_str = " ".join(tokens[ps: pe + 1])
            cur_str = " ".join(tokens[start: end + 1])
            if " ." in prev_str:
                if " ." not in cur_str:
                    out.pop()
                    out.append((start, end, label))
                    head_end = end
            else:
                if " ." not in cur_str and (pe - ps) < (end - start):
                    out.pop()
                    out.append((start, end, label))
                    head_end = end
            continue
        out.append((start, end, label))
        head_end = end
    return out


def entities_to_core_findings(tokens: List[str], entities: List[tuple]) -> List[str]:
    """Ordered per-sentence entity serialization (reference :221-276).

    tokens: the report's token list; entities: [(start, end, label)] in report
    order with RadGraph labels ('ANAT-DP', 'OBS-DP', 'OBS-DA', 'OBS-U', ...).
    Entities of a sentence join in order into one finding string; a 'DA'
    (definitely absent) entity prefixes the sentence with 'no', a 'U'
    (uncertain) with 'maybe' (first modifier wins); single useless findings
    ('It', 'otherwise', ...) are dropped.
    """
    import bisect

    entities = resolve_overlapping_entities(list(entities), tokens)
    dot_index = [i for i, tok in enumerate(tokens) if tok in (".", "?", "!")]
    if dot_index:
        if dot_index[0] != 0:
            dot_index = [0, *dot_index]
        if dot_index[-1] != len(tokens) - 1:
            dot_index = [*dot_index, len(tokens)]
        else:
            dot_index[-1] += 1
    else:
        dot_index = [0, len(tokens)]

    core_findings: List[str] = []
    cur: List[str] = []
    modified = False
    dot_e_idx, pre_sen_idx = -1, -1

    def flush():
        if cur and not (len(cur) == 1 and cur[0] in USELESS_FINDINGS):
            core_findings.append(" ".join(cur))

    for start, end, label in entities:
        ent = " ".join(tokens[start: end + 1]).strip('"').strip("'").strip()
        if ent in _PUNCT_ENTITIES:
            continue
        sen_idx = bisect.bisect_left(dot_index, start)
        if sen_idx != pre_sen_idx:
            flush()
            cur, modified = [], False
            if start == dot_index[sen_idx]:
                dot_e_idx = (dot_index[sen_idx] + 1 if sen_idx == len(dot_index) - 1
                             else dot_index[sen_idx + 1])
                pre_sen_idx = sen_idx + 1
            else:
                dot_e_idx = dot_index[sen_idx]
                pre_sen_idx = sen_idx
        if start <= dot_e_idx < end:  # span crosses the sentence end: trim
            ent = ent.split(".")[0].strip()
        if "DA" in label and not modified:
            cur = ["no", *cur]
            modified = True
        elif "U" in label and not modified:
            cur = ["maybe", *cur]
            modified = True
        cur.append(ent)
    flush()
    return core_findings


def radgraph_jsonl_to_entities(lines) -> Dict[str, Dict]:
    """DyGIE/RadGraph prediction jsonl -> {doc_key: {text, core_findings}}
    (``preprocess_mimic_radgraph_output``, reference :197-286). ``lines`` is an
    iterable of json strings or dicts with predicted_ner/sentences/doc_key."""
    out: Dict[str, Dict] = {}
    for line in lines:
        item = json.loads(line) if isinstance(line, str) else line
        ner = item["predicted_ner"][0]
        tokens = item["sentences"][0]
        if not ner:
            continue
        out[item["doc_key"]] = {
            "text": " ".join(tokens),
            "core_findings": entities_to_core_findings(tokens, ner),
        }
    return out


def merge_core_findings(ann: Dict[str, List[dict]], ent_data: Dict[str, Dict],
                        key_fn=None) -> Dict[str, List[dict]]:
    """Merge serialized entities into an annotation
    (``get_mimic_cxr_annotations``, reference :616-644): items found in
    ent_data get its normalized text + core_findings; others keep their report
    (punctuation-spaced) with empty core_findings."""
    if key_fn is None:
        key_fn = lambda it: f"{it.get('subject_id', '')}_{it.get('study_id', '')}"
    new_ann: Dict[str, List[dict]] = {}
    for split, items in ann.items():
        new_items = []
        for item in items:
            ent = ent_data.get(key_fn(item))
            if ent is not None:
                report, core = ent["text"], ent["core_findings"]
            else:
                report, core = _SPACING_RE.sub(" ", item.get("report", "")), []
            new_items.append({**item, "report": report, "core_findings": core})
        new_ann[split] = new_items
    return new_ann


def serialize_annotation(ann: Dict[str, List[dict]],
                         ner_fn: Optional[Callable[[List[str]], List[List[str]]]] = None,
                         batch_size: int = 64) -> Dict[str, List[dict]]:
    """Fill core_findings + indication_core_findings for every item.

    ner_fn: texts -> list of keyword lists (e.g. evals.adapters.radgraph_serialize);
    falls back to the heuristic extractor.
    """
    for split, items in ann.items():
        reports = [it.get("report", "") for it in items]
        if ner_fn is not None:
            all_kws: List[List[str]] = []
            for start in range(0, len(reports), batch_size):
                all_kws.extend(ner_fn(reports[start:start + batch_size]))
        else:
            all_kws = [heuristic_core_findings(r) for r in reports]
        for item, kws in zip(items, all_kws):
            item["core_findings"] = kws
            ind = extract_section(item.get("raw_report", item.get("report", "")),
                                  "indication")
            if ind and not item.get("indication_core_findings"):
                ind_kws = (ner_fn([ind])[0] if ner_fn is not None
                           else heuristic_core_findings(ind))
                item["indication_core_findings"] = " ".join(ind_kws)
    return ann


def serialize_predictions(pred_csv: str, out_csv: str,
                          ner_fn: Optional[Callable[[List[str]], List[List[str]]]] = None,
                          pred_column: str = "pred_report") -> str:
    """Attach factual serializations to a generated-prediction CSV
    (reference temp_tester.py:138-152 ``extract_factual_serialization``):
    adds a ``gen_fs`` column with the ordered core-finding sentences of each
    generated report. ner_fn defaults to the heuristic extractor when the
    RadGraph stack is unavailable."""
    import csv as _csv

    with open(pred_csv, newline="") as f:
        rows = list(_csv.DictReader(f))
    if pred_column not in (rows[0] if rows else {}):
        # trainer CSVs name prediction columns pred_<epoch>; take the last one
        cands = [c for c in (rows[0] or {}) if c.startswith("pred")]
        if not cands:
            raise ValueError(f"no prediction column in {pred_csv}")
        pred_column = cands[-1]
    reports = [r.get(pred_column) or "" for r in rows]
    if ner_fn is not None:
        fs = []
        for start in range(0, len(reports), 64):
            fs.extend(ner_fn(reports[start:start + 64]))
    else:
        fs = [heuristic_core_findings(r) for r in reports]
    fields = list(rows[0].keys()) + ["gen_fs"] if rows else ["gen_fs"]
    with open(out_csv, "w", newline="") as f:
        w = _csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for row, kws in zip(rows, fs):
            w.writerow({**row, "gen_fs": json.dumps(kws)})
    return out_csv


def serialize_file(ann_path: str, out_path: str, use_radgraph: bool = True) -> str:
    ner_fn = None
    if use_radgraph:
        try:
            from evoke_tpu_torch.evals.adapters import radgraph_serialize
            ner_fn = radgraph_serialize
        except Exception:
            ner_fn = None
    with open(ann_path) as f:
        ann = json.load(f)
    ann = serialize_annotation(ann, ner_fn=ner_fn)
    with open(out_path, "w") as f:
        json.dump(ann, f)
    return out_path
