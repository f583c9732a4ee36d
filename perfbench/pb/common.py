"""Finding the benchmark's parts by name, and the run's shared records.

Every configuration, traffic mix, cell, engine, generator and per-layer
metric is a file of its own under the benchmark's folder, found by the name
``BENCHMARK.json`` or a cell gives it: ``configs/<name>.json``,
``traffic/<name>.json``, ``cells/<name>.json``, ``engines/<name>.py``,
``generators/<name>.py``, ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))    # the benchmark's folder
ROOT = os.path.dirname(HERE)                                          # the checkout


def load_json(kind: str, name: str) -> Dict[str, Any]:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@dataclass
class Study:
    """One study returned by a server: its id, where its inputs live in the
    generator's pool, its forced length (None when unforced) and the tokens
    it was served (up to and including EOS)."""

    id: str
    pool: int
    row: int
    target: Optional[int]
    tokens: Any


@dataclass
class Served:
    """What a window served, by the benchmark's own clock and the program's
    counters."""

    seconds: float
    attempted: int
    studies: List[Study]
    failed: int = 0
    latencies_s: List[float] = field(default_factory=list)
    steps_issued: Optional[int] = None
    trace: Any = None


@dataclass
class Context:
    """A run: the cell and what it names, the run's arguments, the device,
    and what the engine fills in."""

    cell_name: str
    cell: Dict[str, Any]
    cfg: Dict[str, Any]
    traffic: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    window: Optional[Served] = None
    traced: Optional[Served] = None
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Outcome:
    end_to_end: Dict[str, float]
    checks: List[tuple]              # (name, value, limit, passes)
    attempted: int
    failed: int
    memory_peak_bytes: int

    @property
    def correct(self) -> bool:
        return all(ok for _, _, _, ok in self.checks)
