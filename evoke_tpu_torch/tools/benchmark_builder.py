"""Multi-view benchmark construction.

Capability parity: EVOKE modules/building_benchmark.py — construct Multi-view
CXR / Two-view CXR annotations: group images by study, keep studies with >= 2
views and non-empty core findings, merge view-position metadata, and emit
either the anchor/auxiliary layout (one item per study, `create_multiview_cxr`)
or the many-to-many layout (one item per view, each view an anchor with the
others auxiliary, `create_multiview_cxr_multi_to_multi`).
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Dict, List, Optional


def load_mimic_view_positions(metadata_csv: str) -> Dict[str, str]:
    """MIMIC-CXR metadata CSV -> {'{subject}_{study}_{dicom}': ViewPosition}
    (reference building_benchmark.py:69-74; missing positions become 'unk')."""
    out: Dict[str, str] = {}
    with open(metadata_csv, newline="") as f:
        for row in csv.DictReader(f):
            key = f"{row['subject_id']}_{row['study_id']}_{row['dicom_id']}"
            out[key] = row.get("ViewPosition") or "unk"
    return out


def view_positions_for_item(item: dict, meta: Dict[str, str]) -> List[str]:
    """Per-view ViewPosition list for an item: image filename stem is the dicom
    id, keyed '{item id}_{dicom}' (reference :83-92)."""
    vps = []
    for path in (item.get("image_path") or []) + (item.get("multiview_image_path") or []):
        dicom = os.path.basename(path).rsplit(".", 1)[0]
        vps.append(meta.get(f"{item['id']}_{dicom}", "unk"))
    return vps


def build_benchmark_merged(mimic_ann: Dict[str, List[dict]],
                           mimic_meta: Optional[Dict[str, str]] = None,
                           iu_ann: Optional[Dict[str, List[dict]]] = None,
                           iu_meta: Optional[Dict[str, dict]] = None,
                           min_views: int = 2) -> Dict[str, List[dict]]:
    """Multi-view CXR benchmark merge (reference building_benchmark.py:63-141):
    keep studies with >= min_views views and non-empty core findings; attach
    per-view ViewPosition from the MIMIC metadata; append IU X-ray items (png
    path remap, 'unk' positions, comma-cleaned indication)."""
    out: Dict[str, List[dict]] = {k: [] for k in ("train", "val", "test")}
    for split, items in mimic_ann.items():
        for item in items:
            views = list(item.get("image_path") or [])
            if not item.get("core_findings") or len(views) < min_views:
                continue
            out[split].append({
                "id": item["id"],
                "findings": item.get("report", ""),
                "findings_factual_serialization": item["core_findings"],
                "impression": item.get("impression", ""),
                "indication": item.get("indication", ""),
                "indication_pure": item.get("indication_core_findings", ""),
                "image_path": views,
                "view_position": (view_positions_for_item(item, mimic_meta)
                                  if mimic_meta else ["unk"] * len(views)),
                "comparison": item.get("comparison", ""),
                "similar_historical_cases": item.get("specific_knowledge"),
            })
    if iu_ann:
        iu_meta = dict(iu_meta or {})
        for split, items in iu_ann.items():
            for item in items:
                if not item.get("core_findings") or len(item.get("image_path") or []) < min_views:
                    continue
                cur_id = str(item["id"]).split("_")[0]
                meta_item = iu_meta.pop(cur_id, {"image_path": item["image_path"],
                                                 "comparison": ""})
                # 'CXR100_IM-0002/0.jpg' -> 'NLMCXR_png/CXR100_IM-0002/0.png' (:124-125)
                paths = [os.path.join("NLMCXR_png", p.rsplit(".", 1)[0] + ".png")
                         for p in meta_item["image_path"]]
                indication_pure = re.sub(r"\s*,\s*,+", "",
                                         item.get("indication_core_findings", "") or "")
                out[split].append({
                    "id": cur_id,
                    "findings": item.get("report", ""),
                    "findings_factual_serialization": item["core_findings"],
                    "impression": item.get("impression", ""),
                    "indication": item.get("indication", ""),
                    "indication_pure": indication_pure,
                    "image_path": paths,
                    "view_position": ["unk"] * len(paths),
                    "comparison": meta_item.get("comparison", ""),
                    "similar_historical_cases": item.get("specific_knowledge"),
                })
    return out


def build_multiview_annotation(
    ann: Dict[str, List[dict]],
    view_positions: Optional[Dict[str, str]] = None,
    min_views: int = 2,
    many_to_many: bool = False,
    require_core_findings: bool = True,
) -> Dict[str, List[dict]]:
    """Filter/reshape an annotation into a multi-view benchmark.

    ann items follow the base schema (id, subject_id, study_id, report,
    core_findings, image_path list, ...). view_positions maps image path (or
    dicom id) -> ViewPosition string.
    """
    out: Dict[str, List[dict]] = {}
    for split, items in ann.items():
        new_items: List[dict] = []
        for item in items:
            if require_core_findings and not item.get("core_findings"):
                continue
            paths = list(item.get("image_path") or [])
            paths += list(item.get("multiview_image_path") or [])
            # dedup, preserve order
            seen = set()
            views = [p for p in paths if not (p in seen or seen.add(p))]
            if len(views) < min_views:
                continue
            vps = [view_positions.get(p, "") if view_positions else "" for p in views]
            if many_to_many:
                for i, anchor in enumerate(views):
                    aux = views[:i] + views[i + 1:]
                    new_items.append({
                        **{k: v for k, v in item.items()
                           if k not in ("image_path", "multiview_image_path")},
                        "id": f"{item['id']}_v{i}",
                        "image_path": [anchor],
                        "multiview_image_path": aux,
                        "view_position": [vps[i]] + [vps[j] for j in range(len(views))
                                                     if j != i],
                    })
            else:
                new_items.append({
                    **{k: v for k, v in item.items()
                       if k not in ("image_path", "multiview_image_path")},
                    "image_path": [views[0]],
                    "multiview_image_path": views[1:],
                    "view_position": vps,
                })
        out[split] = new_items
    return out


def build_and_save(ann_path: str, out_path: str, **kwargs) -> str:
    with open(ann_path) as f:
        ann = json.load(f)
    out = build_multiview_annotation(ann, **kwargs)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return out_path
