"""Run logger, metric stream and the reference's CSV contracts (the port's own
copy of ``evoke_tpu/core/loggers.py``, written with the ``csv`` module).

- ``RunLogger``: append-only file log duplicated to stdout.
- ``MetricWriter``: one JSON record per event in ``metrics.jsonl``.
- ``append_best_record``: the best-record CSV, one row per call.
- ``PredictionCSV``: val/test_prediction.csv, metric rows first, one column
  per epoch merged on ``images_id``.

The files are byte for byte those the JAX package writes with pandas: comma
delimiter, minimal quoting, ``\\n`` line ends, numbers as ``str`` gives them
(``repr`` for floats), a missing or NaN cell empty. Reading follows pandas'
``read_csv(dtype=str)``: a cell whose whole text is one of pandas' default
missing-value strings (``""``, ``"NA"``, ``"None"``, ``"nan"``, ...) reads
as missing. A second ``update`` is pandas' outer merge on ``images_id``,
which orders the merged rows by ``images_id``: ids that sort before
``"__metric__"`` (a digit or an upper-case first letter) then come before the
metric rows, as they do in the JAX package.
"""

from __future__ import annotations

import csv
import json
import math
import numbers
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# pandas' default missing-value strings (read_csv ``na_values``)
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"])

Row = Dict[str, Optional[str]]


class RunLogger:
    """Append-only file log + stdout duplication."""

    def __init__(self, path: str, echo: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.echo = echo

    def info(self, msg: str) -> None:
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{stamp} | {msg}"
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self.echo:
            print(line, flush=True)


class MetricWriter:
    """jsonl metric stream: one record per event with wall time."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, record: Dict[str, Any]) -> None:
        record = {"ts": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


def _missing(value: Any) -> bool:
    return value is None or (isinstance(value, numbers.Real) and math.isnan(value))


def _cell(value: Any) -> Any:
    """A value as pandas' ``to_csv`` writes it: None and NaN empty."""
    return "" if _missing(value) else value


def _write_csv(path: str, columns: Sequence[str], rows: Sequence[Dict[str, Any]],
               mode: str = "w", header: bool = True) -> None:
    with open(path, mode, newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        if header:
            w.writerow(columns)
        for row in rows:
            w.writerow([_cell(row.get(c)) for c in columns])


def read_csv(path: str) -> Tuple[List[str], List[Row]]:
    """-> (columns, rows) as ``pandas.read_csv(path, dtype=str)`` reads them:
    every cell a string, or None where pandas reads a missing value."""
    with open(path, newline="", encoding="utf-8") as f:
        records = [r for r in csv.reader(f) if r]     # pandas skips blank lines
    columns, body = records[0], records[1:]
    rows = []
    for rec in body:
        rows.append({c: (rec[i] if i < len(rec) and rec[i] not in NA_STRINGS else None)
                     for i, c in enumerate(columns)})
    return columns, rows


def append_best_record(csv_path: str, record: Dict[str, Any]) -> None:
    """Best-record CSV: one row per run with best val/test metrics (a header
    only when the file is new)."""
    _write_csv(csv_path, list(record), [record], mode="a",
               header=not os.path.exists(csv_path))


class PredictionCSV:
    """val/test_prediction.csv: metric rows first, then one row per image id;
    each epoch adds a column, merged on images_id (the reference's contract)."""

    def __init__(self, path: str):
        self.path = path

    def update(self, epoch_label: str, image_ids: Sequence[str], ground_truth: Sequence[str],
               predictions: Sequence[str], metrics: Dict[str, float]) -> None:
        col = f"pred_{epoch_label}"
        rows: List[Dict[str, Any]] = []
        for name, value in metrics.items():
            rows.append({"images_id": f"__metric__{name}", "ground_truth": name, col: value})
        for iid, gt, pred in zip(image_ids, ground_truth, predictions):
            rows.append({"images_id": iid, "ground_truth": gt, col: pred})
        if not os.path.exists(self.path):
            _write_csv(self.path, ["images_id", "ground_truth", col], rows)
            return
        old_cols, old_rows = read_csv(self.path)
        old_cols = [c for c in old_cols if c != col]
        # the new rows as text, as pandas' astype(str) makes them (missing stays missing)
        new_rows = [{k: None if _missing(v) else str(v) for k, v in r.items()} for r in rows]
        self._merge_write(old_cols, old_rows, new_rows, col)

    def _merge_write(self, old_cols: List[str], old_rows: List[Row], new_rows: List[Row],
                     col: str) -> None:
        """pandas' ``old.merge(new, on="images_id", how="outer")`` with the
        ground truth filled from the new rows where the old one is missing:
        keys in sorted order, a key's rows the product of its old and new rows."""
        by_old: Dict[Optional[str], List[Row]] = {}
        by_new: Dict[Optional[str], List[Row]] = {}
        for r in old_rows:
            by_old.setdefault(r.get("images_id"), []).append(r)
        for r in new_rows:
            by_new.setdefault(r["images_id"], []).append(r)
        keys = sorted(set(by_old) | set(by_new), key=lambda k: (k is None, k or ""))
        merged: List[Row] = []
        for key in keys:
            for old in by_old.get(key, [None]):
                for new in by_new.get(key, [None]):
                    row: Row = {c: (old.get(c) if old else None) for c in old_cols}
                    row["images_id"] = key
                    if row.get("ground_truth") is None and new is not None:
                        row["ground_truth"] = new["ground_truth"]
                    row[col] = new[col] if new is not None else None
                    merged.append(row)
        _write_csv(self.path, old_cols + [col], merged)

    @staticmethod
    def read_metrics(path: str) -> Dict[str, Dict[str, float]]:
        """Read back the metric rows: {metric_name: {column: value}}."""
        columns, rows = read_csv(path)
        out: Dict[str, Dict[str, float]] = {}
        for row in rows:
            iid = str(row["images_id"])
            if iid.startswith("__metric__"):
                out[iid[len("__metric__"):]] = {c: float(row[c]) for c in columns
                                                if c.startswith("pred_") and row[c] is not None}
        return out
