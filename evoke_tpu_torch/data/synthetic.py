"""Synthetic data for tests, smoke runs and dry runs (the port's own copy of
``evoke_tpu/data/synthetic.py``).

(a) in-memory static-shape batches in the training layout and (b)
reference-format annotation JSONs backed by ``.npy`` images, so the whole data
pipeline runs hermetically. The numpy draws are the JAX package's, call for
call: the same seed writes byte-identical files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

_WORDS = ("the heart is normal in size . the lungs are clear . no acute cardiopulmonary "
          "abnormality . there is no pleural effusion or pneumothorax . mild cardiomegaly "
          "is present . bibasilar atelectasis noted . no focal consolidation .").split()

_FINDINGS = ["normal heart", "clear lungs", "no effusion", "cardiomegaly",
             "atelectasis", "no pneumothorax", "consolidation"]

_INDICATIONS = ["chest pain", "shortness of breath", "fever and cough", "follow up"]


def synthetic_report(rng: np.random.Generator, n_sentences: int = 3) -> str:
    sents = []
    for _ in range(n_sentences):
        n = int(rng.integers(3, 8))
        sents.append(" ".join(rng.choice(_WORDS, size=n)) + " .")
    return " ".join(sents)


def synthetic_batch(rng: np.random.Generator, tokenizer, batch: int = 8, image_size: int = 64,
                    max_seq_len: int = 24, n_aux: Optional[int] = None,
                    aux_used_frac: float = 0.75, with_indication: bool = False,
                    fixed_reports: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    """One static-shape training batch in the reference layout: ``batch`` study
    anchors first, then ``n_aux`` auxiliary-view slots (some padding-invalid).

    images [batch+n_aux, H, W, 3]; ids/mask [batch, L]; pids/valid [batch+n_aux].
    """
    if n_aux is None:
        n_aux = batch // 2
    total = batch + n_aux
    images = rng.normal(size=(total, image_size, image_size, 3)).astype(np.float32)
    pids = np.empty(total, np.int32)
    pids[:batch] = np.arange(batch)
    valid = np.ones(total, bool)
    n_used = int(round(n_aux * aux_used_frac))
    for j in range(n_aux):
        if j < n_used:
            pids[batch + j] = j % batch      # aux view of study j
        else:
            pids[batch + j] = -1 - j         # padding slot: unique negative code
            valid[batch + j] = False
    reports = fixed_reports or [synthetic_report(rng) for _ in range(batch)]
    ids = np.stack([tokenizer.encode_padded(r, max_seq_len, add_bos_eos=True) for r in reports])
    mask = (ids != tokenizer.pad_id).astype(np.int32)
    out = {
        "images": images,
        "ids": ids,
        "mask": mask,
        "pids": pids,
        "valid": valid,
    }
    if with_indication:
        incs = [str(rng.choice(_INDICATIONS)) for _ in range(batch)]
        inc_ids = np.stack([tokenizer.encode_padded(s, max_seq_len, add_cls=True) for s in incs])
        out["inc_ids"] = inc_ids
        out["inc_mask"] = (inc_ids != tokenizer.pad_id).astype(np.int32)
    return out


def write_synthetic_dataset(root: str, n_train: int = 16, n_val: int = 4, n_test: int = 4,
                            image_size: int = 64, seed: int = 0,
                            multiview_frac: float = 0.6) -> str:
    """Write a reference-format annotation JSON + .npy images; returns ann path."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    ann: Dict[str, list] = {}
    uid = 0
    for split, count in (("train", n_train), ("val", n_val), ("test", n_test)):
        items = []
        for _ in range(count):
            sid = f"s{uid}"
            n_views = 1 + int(rng.random() < multiview_frac)
            paths = []
            for v in range(n_views):
                p = f"images/{sid}_v{v}.npy"
                img = rng.normal(size=(image_size, image_size, 3)).astype(np.float32)
                np.save(os.path.join(root, p), img)
                paths.append(p)
            report = synthetic_report(rng)
            findings = list(rng.choice(_FINDINGS, size=int(rng.integers(1, 4)), replace=False))
            items.append({
                "id": sid,
                "subject_id": f"p{uid % 7}",
                "study_id": sid,
                "report": report,
                "core_findings": findings,
                "image_path": [paths[0]],
                "multiview_image_path": paths[1:],
                "indication_core_findings": (str(rng.choice(_INDICATIONS))
                                             if rng.random() < 0.7 else ""),
                "view_position": ["PA", "LATERAL"][: n_views],
            })
            uid += 1
        ann[split] = items
    path = os.path.join(root, "annotation.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path
