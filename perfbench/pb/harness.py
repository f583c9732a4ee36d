"""The run: arguments, the card check, the cell's engine, the result line.

``run_cell`` is the whole run but the card check, so a test drives it on the
CPU at a small size; ``main`` is the command.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from pb.common import Context, Outcome, load_benchmark, load_json, load_module

FORBIDDEN = ("jax", "jaxlib", "flax", "evoke_tpu")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of the benchmark.")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: report the per-layer metrics of a traced window")
    return ap.parse_args(argv)


def make_context(workload: str, seed: int, seconds: float, trace: bool, device,
                 t_start: float, cell: Optional[Dict] = None, cfg: Optional[Dict] = None,
                 traffic: Optional[Dict] = None) -> Context:
    """The run's context; ``cell``, ``cfg`` and ``traffic`` replace what the
    names would load (a test's small sizes)."""
    cell = cell if cell is not None else load_json("cells", workload)
    cfg = cfg if cfg is not None else load_json("configs", cell["config"])
    traffic = traffic if traffic is not None else load_json("traffic", cell["traffic"])
    return Context(workload, cell, cfg, traffic, int(seed) % 2 ** 63, float(seconds),
                   bool(trace), device, t_start)


def run_cell(ctx: Context) -> Outcome:
    return load_module("engines", ctx.cell["engine"]).run(ctx)


def cell_metrics(bench: Dict, ctx: Context, outcome: Outcome) -> Dict[str, Dict]:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones."""
    mine = [m for m in bench["end_to_end"]
            if ctx.cell_name in m.get("workloads", [ctx.cell_name])]
    if not ctx.trace:
        out = {}
        for m in mine:
            if m["name"] not in outcome.end_to_end:
                raise KeyError(f"{ctx.cell_name}: the engine took no {m['name']}")
            out[m["name"]] = {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    out = {}
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']}: no 'workloads' names its cells")
        if ctx.cell_name not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(bench: Dict, ctx: Context, outcome: Outcome, kind: str, count: int) -> Dict:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": cell_metrics(bench, ctx, outcome),
            "device": {"platform": "gpu", "kind": kind, "count": count,
                       "memory_peak_bytes": outcome.memory_peak_bytes}}
    tr = ctx.traced.trace if ctx.traced is not None else None
    if tr is not None:
        line["device"]["busy_s"] = tr.busy_s
        line["device"]["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit, _ in outcome.checks}
    return line


def forbidden_modules() -> List[str]:
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = load_benchmark()
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"perfbench: {args.workload!r} is no cell of BENCHMARK.json", file=sys.stderr)
        return 2
    cell = load_json("cells", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = make_context(args.workload, args.seed, args.seconds, bool(args.trace), device,
                       t_start, cell=cell)
    outcome = run_cell(ctx)
    line = result_line(bench, ctx, outcome, torch.cuda.get_device_name(0), int(cell["chips"]))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in outcome.checks:
        print(f"check {name}: {value} (limit {limit}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
