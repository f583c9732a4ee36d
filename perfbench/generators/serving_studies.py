"""Chest X-ray studies for the serving cells, drawn from the run's seed.

A loader batch holds ``studies_per_batch`` anchors, then each anchor's
auxiliary views of the same study (``aux_views_cycle[i % len]`` of them for
anchor i), as uint8 images at the configuration's size, with each anchor's
indication (word-level ids, padded to the report length). A pool of
``pool_batches`` such batches is made once and cycled; every study that
leaves the generator gets a fresh id and, when ``report_words`` is given, a
fresh target length drawn from its lognormal (median, sigma, clip), which
the hooks force. Lengths come from their own stream of the seed, so a
stream's lengths do not depend on the pool.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional

import numpy as np

N_SPECIAL = 5     # [PAD] [CLS] [SEP] [MASK] [UNK]


def lognormal_lengths(rng: np.random.Generator, spec: Dict, n: int) -> np.ndarray:
    lo, hi = spec["clip"]
    x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
    return np.clip(np.round(x), lo, hi).astype(np.int32)


class Studies:
    def __init__(self, traffic: Dict, cfg: Dict, seed: int):
        m = cfg["model"]
        self.n = int(traffic["studies_per_batch"])
        cycle = traffic["aux_views_cycle"]
        aux = [i for i in range(self.n) for _ in range(cycle[i % len(cycle)])]
        self.pids = np.asarray(list(range(self.n)) + aux, np.int32)
        self.report_words: Optional[Dict] = traffic.get("report_words")
        self.max_len = int(m["max_seq_len"])
        vocab = int(m["vocab_size"])
        size = int(cfg["image_size"])
        rng = np.random.default_rng([int(seed), 1])
        b = len(self.pids)
        self.pool = []
        for _ in range(int(traffic["pool_batches"])):
            inc_len = lognormal_lengths(rng, traffic["indication_words"], self.n)
            inc = rng.integers(N_SPECIAL, vocab - 2, (self.n, self.max_len)).astype(np.int32)
            inc_mask = (np.arange(self.max_len)[None] < inc_len[:, None]).astype(np.int32)
            self.pool.append({
                "images": rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
                "ids": np.zeros((self.n, self.max_len), np.int32),
                "mask": np.ones((self.n, self.max_len), np.int32),
                "pids": self.pids,
                "valid": np.ones(b, bool),
                "inc_ids": inc * inc_mask,
                "inc_mask": inc_mask,
            })

    def stream(self, seed: int, stream: int, tag: str) -> Iterator[Dict]:
        """Endless loader batches: the pool cycled, each study with a fresh id
        ``{tag}{batch}:{pool}:{row}`` and, with ``report_words``, its target
        length in ``target_len`` (device) and ``_aux`` (host)."""
        rng = np.random.default_rng([int(seed), 2, int(stream)])
        for k in itertools.count():
            p = k % len(self.pool)
            bt = dict(self.pool[p])
            bt["_image_ids"] = [f"{tag}{k}:{p}:{j}" for j in range(self.n)]
            if self.report_words is not None:
                lengths = lognormal_lengths(rng, self.report_words, self.n)
                bt["target_len"] = lengths
                bt["_aux"] = lengths
            yield bt

    def study_inputs(self, pool_index: int, rows) -> Dict[str, np.ndarray]:
        """The anchors ``rows`` of a pool batch with every view of their
        studies: anchors first, in the order given, then their views."""
        bt = self.pool[pool_index]
        rows = list(rows)
        views = [v for v in range(self.n, len(self.pids)) if self.pids[v] in set(rows)]
        idx = rows + views
        return {"images": bt["images"][idx], "pids": self.pids[idx],
                "valid": bt["valid"][idx], "inc_ids": bt["inc_ids"][rows],
                "inc_mask": bt["inc_mask"][rows]}


def make(traffic: Dict, cfg: Dict, seed: int) -> Studies:
    return Studies(traffic, cfg, seed)
