"""Annotation JSON -> typed study examples (the port's own copy of
``evoke_tpu/data/datasets.py``; host-side, no torch).

Annotation JSON = {train/val/test: [{id, subject_id, study_id, report,
core_findings, image_path (list), multiview_image_path (list),
indication_core_findings, specific_knowledge, ...}]}; the Multi-view CXR
schema (anchor_scan / auxiliary_references /
findings_factual_serialization) is normalised onto it. Items with empty
core_findings are skipped; finetune items split into has-indication and
no-indication streams.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class Example:
    id: str
    study_key: str                     # same-study grouping key (patient_id in the reference)
    anchor_path: str
    aux_paths: List[str]
    report: str = ""                   # raw report text
    align_text: str = ""               # contrastive text: '[CLS] kw [SEP] kw ...' or report
    indication: str = ""               # '[CLS] ...' or "" when absent
    knowledge: Optional[Dict] = None   # specific_knowledge passthrough


def _study_key_from_path(path: str) -> Optional[str]:
    """MIMIC layout files/pXX/pXXXXXXXX/sYYYYYYYY/img.jpg -> 'pXXXXXXXX_sYYYYYYYY'
    (the reference's patient_id, dataloaders_v0401.py:79-84)."""
    parts = path.split("/")
    if len(parts) == 4:
        return "_".join(parts[1:3])
    return None


def _normalize_item(item: Dict) -> Dict:
    """Map the Multi-view CXR schema onto the MIMIC one."""
    if "anchor_scan" in item:
        out = dict(item)
        anchor = item["anchor_scan"]
        aux = item.get("auxiliary_references", {})
        out["image_path"] = anchor.get("image_path", anchor) if isinstance(anchor, dict) \
            else [anchor]
        if isinstance(out["image_path"], str):
            out["image_path"] = [out["image_path"]]
        aux_paths = aux.get("image_path", aux) if isinstance(aux, dict) else aux
        out["multiview_image_path"] = aux_paths or []
        out.setdefault("core_findings",
                       item.get("findings_factual_serialization", []))
        return out
    return item


def _study_key(item: Dict) -> str:
    if item.get("subject_id") is not None and item.get("study_id") is not None:
        return f"p{item['subject_id']}_s{item['study_id']}"
    paths = item.get("image_path") or []
    if paths:
        k = _study_key_from_path(paths[0])
        if k:
            return k
    return str(item["id"])


def load_annotation(ann_path: str) -> Dict[str, List[Dict]]:
    with open(ann_path) as f:
        return json.load(f)


def parse_pretrain(ann: Dict[str, List[Dict]], split: str, align_type: str = "keywords",
                   uncased: bool = True) -> List[Example]:
    out = []
    seen = set()
    for raw in ann[split]:
        item = _normalize_item(raw)
        if not item.get("core_findings"):
            continue
        if item["id"] in seen:
            continue
        seen.add(item["id"])
        if align_type == "keywords":
            kws = [str(k).lower() if uncased else str(k) for k in item["core_findings"]]
            text = "[CLS] " + " [SEP] ".join(kws)
        else:
            rep = item["report"].lower() if uncased else item["report"]
            text = "[CLS] " + rep
        out.append(Example(
            id=str(item["id"]),
            study_key=_study_key(item),
            anchor_path=item["image_path"][0],
            aux_paths=(list(item["image_path"][1:])
                       + list(item.get("multiview_image_path") or [])),
            report=item.get("report", ""),
            align_text=text,
        ))
    return out


def parse_finetune(ann: Dict[str, List[Dict]], split: str, uncased: bool = True
                   ) -> Tuple[List[Example], List[Example]]:
    """-> (has_indication, no_indication) example streams."""
    has_ind, no_ind = [], []
    for raw in ann[split]:
        item = _normalize_item(raw)
        if not item.get("core_findings"):
            continue
        rep = item["report"].lower() if uncased else item["report"]
        ind = item.get("indication_core_findings") or ""
        if isinstance(ind, list):
            ind = " ".join(str(x) for x in ind)
        ind = ind.lower() if uncased else ind
        ex = Example(
            id=str(item["id"]),
            study_key=_study_key(item),
            anchor_path=item["image_path"][0],
            aux_paths=(list(item["image_path"][1:])
                       + list(item.get("multiview_image_path") or [])),
            report=rep,
            indication=("[CLS] " + ind) if ind else "",
            knowledge=item.get("specific_knowledge"),
        )
        (has_ind if ind else no_ind).append(ex)
    return has_ind, no_ind
