"""Trace capture + aggregation (port of ``evoke_tpu/core/profiling.py``).

``capture_trace`` runs one call under ``torch.profiler`` (the CPU, plus the
card's kernels when CUDA is available) and writes a gzipped Chrome trace
(``*.trace.json.gz``) into a directory; ``summarize_trace`` digests it into
per-op totals — no TensorBoard required. Ops executed once per call are the
encoder / epilogue; ops executed N times are the decode loop body, and their
per-step cost is what to optimize. ``summarize_trace`` and
``format_summary`` are the JAX module's, unchanged.

Usage:
    from evoke_tpu_torch.core.profiling import capture_trace, summarize_trace
    outdir = capture_trace(lambda: server.serve(batches), "/tmp/trace")
    report = summarize_trace(outdir)
    print(format_summary(report))
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional


def capture_trace(fn: Callable[[], object], outdir: str) -> str:
    """Run ``fn`` once under a torch.profiler trace; return the trace
    directory. The card is synchronised before the trace closes, so its
    kernels are in the trace even when ``fn`` returns before they finish."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(outdir, f"torch_{time.time_ns()}.trace.json.gz"))
    return outdir


def _find_trace_file(outdir: str) -> Optional[str]:
    files = sorted(glob.glob(os.path.join(outdir, "**", "*.trace.json.gz"),
                             recursive=True))
    return files[-1] if files else None


def summarize_trace(outdir: str, loop_threshold: int = 8) -> Dict[str, object]:
    """Aggregate complete ('X') events from the newest trace in ``outdir``.

    Returns {'ops': [...], 'loop_ops': [...], 'loop_total_us', 'oneshot_total_us'}.
    Ops with count >= loop_threshold are classified as loop-body ops (executed
    once per decode step / scan iteration); their 'per_iter_us' is total/count.
    Host-side python frames ('$...'), jit wrappers and transfer markers are
    dropped from the one-shot bucket so it reflects device work.
    """
    f = _find_trace_file(outdir)
    if f is None:
        raise FileNotFoundError(f"no *.trace.json.gz under {outdir}")
    with gzip.open(f, "rt") as fh:
        data = json.load(fh)
    # drop whole-step markers: the runtime emits one event per step (named by
    # its step number) on a "Steps" thread whose duration spans every op — it
    # would double-count the entire program as one giant "one-shot op"
    step_threads = {
        (e.get("pid"), e.get("tid"))
        for e in data.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "thread_name"
        and "Steps" in str(e.get("args", {}).get("name", ""))}
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        if (e.get("pid"), e.get("tid")) in step_threads:
            continue
        name = e.get("name", "")
        agg[name] += e.get("dur", 0)
        cnt[name] += 1

    def host_side(name: str) -> bool:
        return (name.startswith("$") or name.startswith("jit_")
                or "PjitFunction" in name or "asarray" in name
                or name.startswith("while") or name in ("ParseArguments",))

    loop_ops: List[Dict] = []
    oneshot: List[Dict] = []
    for name, c in cnt.items():
        row = {"name": name, "count": c, "total_us": agg[name],
               "type": re.split(r"[._]\d", name)[0]}
        if c >= loop_threshold and not host_side(name):
            row["per_iter_us"] = agg[name] / c
            loop_ops.append(row)
        elif not host_side(name):
            oneshot.append(row)
    loop_ops.sort(key=lambda r: -r["total_us"])
    oneshot.sort(key=lambda r: -r["total_us"])

    by_type: collections.Counter = collections.Counter()
    for r in loop_ops:
        by_type[r["type"]] += r["total_us"]
    oneshot_by_type: collections.Counter = collections.Counter()
    for r in oneshot:
        oneshot_by_type[r["type"]] += r["total_us"]
    return {
        "trace_file": f,
        "loop_ops": loop_ops,
        "oneshot_ops": oneshot,
        "loop_total_us": sum(r["total_us"] for r in loop_ops),
        "oneshot_total_us": sum(r["total_us"] for r in oneshot),
        "loop_by_type_us": dict(by_type.most_common()),
        "oneshot_by_type_us": dict(oneshot_by_type.most_common()),
    }


def format_summary(report: Dict[str, object], top: int = 12) -> str:
    """Human-readable digest of ``summarize_trace`` output."""
    lines = [
        f"loop ops: {report['loop_total_us'] / 1e3:.1f} ms total, "
        f"one-shot ops: {report['oneshot_total_us'] / 1e3:.1f} ms",
        "loop time by op type:",
    ]
    for typ, us in list(report["loop_by_type_us"].items())[:top]:
        lines.append(f"  {us / 1e3:8.2f} ms  {typ}")
    lines.append("one-shot time by op type:")
    for typ, us in list(report.get("oneshot_by_type_us", {}).items())[:top]:
        lines.append(f"  {us / 1e3:8.2f} ms  {typ}")
    lines.append("hottest one-shot (encoder/epilogue) ops:")
    for r in report["oneshot_ops"][:top]:
        lines.append(f"  {r['total_us'] / 1e3:8.2f} ms x{r['count']}  {r['name'][:70]}")
    return "\n".join(lines)
