"""Patient-specific knowledge retrieval: exact inner-product top-k on the card
(port of evoke_tpu/retrieval/topk.py).

``TopKIndex.search`` runs a float32 product of the queries with each
database chunk (TF32 off), masks same-study rows to -1e30, and merges the
chunk's top-k into a running top-k buffer. Ties keep the lower database
index, as ``jax.lax.top_k`` does: both top-k selections are stable sorts
(``torch.topk`` promises no order among equal values), and the merge puts
the running buffer first. The buffer starts as (-1e30, index 0), so a query
with fewer than k candidates from other studies gets index 0 in its empty
slots, as JAX's does.

The database may live on the host (a numpy array or a CPU tensor, of any
float dtype: chunks are cast to float32 on the device) or on the device. A
host database searched on the card is copied once into pinned memory and
streamed chunk by chunk on a side stream, one chunk ahead of the product.

``encode_corpus``, ``attach_specific_knowledge``, ``build_knowledge_annotation``,
``retrieval_quality`` and ``plot_topk_images`` write and score the augmented
annotation ({sk_ids, reports, sk_keywords} per item) as the JAX package does.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from evoke_tpu_torch.core.device import resolve_device

NEG_INF = -1e30


def stable_code(key: str) -> int:
    """Process-independent 63-bit study code (sha1-based): Python's ``hash()``
    is salted per process."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big") & 0x7FFFFFFFFFFFFFFF


def _stable_topk(x, k: int):
    """(values, positions) of the k largest of each row, in descending order,
    equal values by lower position (``jax.lax.top_k``'s order)."""
    values, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], pos[:, :k]


def _chunk_topk(queries, db_chunk, chunk_start: int, best_scores, best_idx, k: int,
                query_study, db_study_chunk):
    """Merge the top-k of ``queries @ db_chunk.T`` (float32) into the running
    (best_scores, best_idx); same-study rows are masked to -1e30 first."""
    sims = queries @ db_chunk.float().t()
    sims = torch.where(query_study[:, None] == db_study_chunk[None, :], NEG_INF, sims)
    scores, idx = _stable_topk(sims, min(k, db_chunk.shape[0]))
    merged_scores = torch.cat([best_scores, scores], dim=1)
    merged_idx = torch.cat([best_idx, idx + chunk_start], dim=1)
    new_scores, pos = _stable_topk(merged_scores, k)
    return new_scores, torch.gather(merged_idx, 1, pos)


class TopKIndex:
    """Exact inner-product top-k over a database of [N, D] embeddings,
    computed on ``device``."""

    def __init__(self, embeddings, study_codes: np.ndarray, ids: Sequence[str],
                 chunk_size: int = 4096, device="cuda"):
        if not (embeddings.shape[0] == len(ids) == study_codes.shape[0]):
            raise ValueError(f"{embeddings.shape[0]} embeddings, {len(ids)} ids, "
                             f"{study_codes.shape[0]} study codes")
        self.device = resolve_device(device)
        db = torch.as_tensor(embeddings)
        if db.device.type == "cpu" and self.device.type == "cuda" and not db.is_pinned():
            db = db.pin_memory()
        self.db = db
        self.study_codes = torch.as_tensor(np.asarray(study_codes, np.int64), device=self.device)
        self.ids = list(ids)
        self.chunk_size = chunk_size
        self.h2d_bytes = 0     # what the last search copied host -> device

    def _chunks(self):
        """(start, chunk on the device) for each database chunk; a host
        database on the card is copied on a side stream, one chunk ahead."""
        n, cs = self.db.shape[0], self.chunk_size
        starts = range(0, n, cs)
        if self.db.device.type == self.device.type:
            for s in starts:
                yield s, self.db[s:s + cs].to(self.device)
            return
        copy_stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)

        def start_copy(s):
            with torch.cuda.stream(copy_stream):
                chunk = self.db[s:s + cs].to(self.device, non_blocking=True)
            self.h2d_bytes += chunk.numel() * chunk.element_size()
            return s, chunk

        pending = start_copy(0)
        for nxt in list(starts[1:]) + [None]:
            s, chunk = pending
            main.wait_stream(copy_stream)
            chunk.record_stream(main)
            if nxt is not None:
                pending = start_copy(nxt)
            yield s, chunk

    @torch.no_grad()
    def search(self, queries, query_study_codes: np.ndarray, k: int,
               query_chunk: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
        """-> (scores [Q, k] float32, indices [Q, k] int64) excluding
        same-study entries; k is cut to the database's size."""
        n = self.db.shape[0]
        k = min(k, n)
        queries = torch.as_tensor(queries)
        codes = torch.as_tensor(np.asarray(query_study_codes, np.int64))
        self.h2d_bytes = 0
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False     # a near tie can flip under TF32
        try:
            return self._search(queries, codes, k, query_chunk)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def _search(self, queries, codes, k: int, query_chunk: int):
        out_scores, out_idx = [], []
        for qs in range(0, queries.shape[0], query_chunk):
            q = queries[qs:qs + query_chunk].to(self.device).float()
            qc = codes[qs:qs + query_chunk].to(self.device)
            best_s = torch.full((q.shape[0], k), NEG_INF, dtype=torch.float32,
                                device=self.device)
            best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=self.device)
            for start, chunk in self._chunks():
                best_s, best_i = _chunk_topk(q, chunk, start, best_s, best_i, k, qc,
                                             self.study_codes[start:start + chunk.shape[0]])
            out_scores.append(best_s.cpu().numpy())
            out_idx.append(best_i.cpu().numpy())
        return np.concatenate(out_scores), np.concatenate(out_idx)


def encode_corpus(encode_fn, loader, flatten: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Run ``encode_fn(batch) -> [n_anchor, T, D]`` over a loader's batches;
    -> (embeddings [N, T*D], study codes [N], ids [N]) of the valid anchors.
    A study code hashes the batch's ``_study_keys`` entry, else the image id."""
    embs, codes, ids = [], [], []
    for batch in loader:
        out = torch.as_tensor(encode_fn(batch)).float().cpu().numpy()
        for i in range(len(batch["_image_ids"])):
            if not batch["valid"][i]:
                continue
            embs.append(out[i].reshape(-1) if flatten else out[i])
            ids.append(batch["_image_ids"][i])
            codes.append(stable_code(batch["_study_keys"][i]) if "_study_keys" in batch
                         else stable_code(batch["_image_ids"][i]))
    return np.stack(embs), np.asarray(codes, np.int64), ids


def attach_specific_knowledge(ann: Dict[str, List[dict]], split: str,
                              results_ids: Dict[str, List[str]],
                              id_to_item: Dict[str, dict], topk: int) -> None:
    """Write {sk_ids, reports, sk_keywords} into ann[split] items in place."""
    for item in ann[split]:
        hits = results_ids.get(str(item["id"]), [])[:topk]
        item["specific_knowledge"] = {
            "sk_ids": hits,
            "reports": [id_to_item[h]["report"] for h in hits if h in id_to_item],
            "sk_keywords": [id_to_item[h].get("core_findings", [])
                            for h in hits if h in id_to_item],
        }


def build_knowledge_annotation(ann_path: str, out_path: str, splits: Sequence[str],
                               results_by_split: Dict[str, Dict[str, List[str]]],
                               topk: int) -> str:
    with open(ann_path) as f:
        ann = json.load(f)
    id_to_item = {str(it["id"]): it for it in ann.get("train", [])}
    for split in splits:
        attach_specific_knowledge(ann, split, results_by_split[split], id_to_item, topk)
    with open(out_path, "w") as f:
        json.dump(ann, f)
    return out_path


def retrieval_quality(ann: Dict[str, List[dict]], split: str,
                      id_to_item: Dict[str, dict], topk: int = 5) -> Dict[str, float]:
    """Mean BLEU-4 and ROUGE-L of each query's best retrieved report, and
    BLEU-4 over all its top-k, against its own report: a check of the
    stage-1 embedding space before stage 2."""
    from evoke_tpu_torch.evals.nlg import bleu, rouge_l

    gts, best_res, all_pairs = {}, {}, []
    for item in ann[split]:
        sk = item.get("specific_knowledge") or {}
        reports = [r for r in sk.get("reports", [])[:topk] if r]
        if not reports or not item.get("report"):
            continue
        iid = str(item["id"])
        gts[iid] = [item["report"]]
        best_res[iid] = [reports[0]]
        all_pairs.extend((item["report"], r) for r in reports)
    if not gts:
        return {"n_scored": 0.0}
    b_best, _ = bleu(gts, best_res, 4)
    r_best, _ = rouge_l(gts, best_res)
    b_all, _ = bleu({i: [g] for i, (g, _) in enumerate(all_pairs)},
                    {i: [r] for i, (_, r) in enumerate(all_pairs)}, 4)
    return {"n_scored": float(len(gts)), "retrieved_top1_BLEU_4": b_best[3],
            "retrieved_top1_ROUGE_L": r_best, "retrieved_topk_mean_BLEU_4": b_all[3]}


def plot_topk_images(ann: Dict[str, List[dict]], split: str, id_to_item: Dict[str, dict],
                     image_dir: str, out_dir: str, topk: int = 3, n_studies: int = 10,
                     db_image_dir: Optional[str] = None, seed: int = 0) -> List[str]:
    """For ``n_studies`` studies of ``split`` (a seeded sample) that carry
    ``specific_knowledge``, write a 2 x 2 PNG grid: the anchor image, titled
    with the BLEU-4 / ROUGE-L of its top-1 retrieved report against its own,
    and its top-``topk`` retrieved images. Returns the written paths."""
    from PIL import Image, ImageDraw

    from evoke_tpu_torch.evals.nlg import bleu, rouge_l

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    items = [it for it in ann.get(split, [])
             if (it.get("specific_knowledge") or {}).get("sk_ids") and it.get("image_path")]
    if not items:
        return []
    tile = 256
    written = []
    for i in rng.permutation(len(items))[:n_studies]:
        item = items[int(i)]
        sk = item["specific_knowledge"]
        hits = [h for h in sk["sk_ids"][:topk] if h in id_to_item]
        paths = [os.path.join(image_dir, item["image_path"][0])]
        paths += [os.path.join(db_image_dir or image_dir, id_to_item[h]["image_path"][0])
                  for h in hits]
        title = "no report"
        if item.get("report") and sk.get("reports"):
            g, r = {"0": [item["report"]]}, {"0": [sk["reports"][0]]}
            b4, _ = bleu(g, r, 4)
            rl, _ = rouge_l(g, r)
            title = f"top1 bleu4:{b4[3]:.3f} rouge_l:{rl:.3f}"
        canvas = Image.new("RGB", (2 * tile, 2 * tile), (0, 0, 0))
        for j, path in enumerate(paths[:4]):
            try:
                img = Image.open(path).convert("RGB").resize((tile, tile))
            except OSError:
                img = Image.new("RGB", (tile, tile), (40, 40, 40))
            canvas.paste(img, ((j % 2) * tile, (j // 2) * tile))
        draw = ImageDraw.Draw(canvas)
        draw.rectangle([0, 0, 2 * tile, 14], fill=(0, 0, 0))
        draw.text((2, 2), title, fill=(255, 255, 0))
        out = os.path.join(out_dir, f"{split}_{item['id']}_specific_knowledge.png")
        canvas.save(out)
        written.append(out)
    return written
