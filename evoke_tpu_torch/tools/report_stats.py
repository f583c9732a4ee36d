"""Report length/sentence statistics (EVOKE modules/sta_reports_sitation.py parity)."""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

import numpy as np

_SENT_SPLIT = re.compile(r"(?<=[.?!])\s+")


def report_stats(reports: Iterable[str]) -> Dict[str, float]:
    """Token/sentence count distributions over a report corpus."""
    tok_lens: List[int] = []
    sent_counts: List[int] = []
    for r in reports:
        toks = r.split()
        tok_lens.append(len(toks))
        sent_counts.append(len([s for s in _SENT_SPLIT.split(r.strip()) if s.strip()]))
    tl = np.asarray(tok_lens) if tok_lens else np.zeros(1)
    sc = np.asarray(sent_counts) if sent_counts else np.zeros(1)
    return {
        "n_reports": float(len(tok_lens)),
        "tokens_mean": float(tl.mean()),
        "tokens_p50": float(np.percentile(tl, 50)),
        "tokens_p95": float(np.percentile(tl, 95)),
        "tokens_max": float(tl.max()),
        "sentences_mean": float(sc.mean()),
        "sentences_p95": float(np.percentile(sc, 95)),
    }
