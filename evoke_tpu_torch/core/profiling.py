"""Trace capture + aggregation (port of ``evoke_tpu/core/profiling.py``).

``capture_trace`` runs one call under ``torch.profiler`` (the CPU, plus the
card's kernels when CUDA is available) and writes a gzipped Chrome trace
(``*.trace.json.gz``) into a directory; ``summarize_trace`` digests it into
per-op totals — no TensorBoard required. Ops executed once per call are the
encoder / epilogue; ops executed N times are the decode loop body, and their
per-step cost is what to optimize. ``summarize_trace`` and
``format_summary`` are the JAX module's, unchanged.

``spans`` is the program's span recorder: the servers open a
``span(name, **ids)`` at each layer boundary. Off (the default) a span site
keeps no span; it reads the
clock twice and adds to its name's running total of seconds and calls
(``spans.seconds``), which the servers' ``stats`` read. On
(``spans.enable()``), each span is kept in memory with its start and end on
the profiler's clock (Unix-epoch nanoseconds, as kineto stamps its events),
its parent (from a per-thread stack), its thread and the ids of the work it
belongs to (a batch number, a ticket; a child inherits its parent's), until
``spans.drain()`` hands them over. ``capture_trace`` writes the spans taken
during the capture into its Chrome trace, over the kernels.

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
import itertools
import json
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

SPANS_PROCESS = "program spans"     # the Chrome trace's process of the program's spans


class Span(NamedTuple):
    """One recorded span: epoch nanoseconds (the profiler's clock), its own
    id and its parent's (0: a root), the thread that ran it, and its ids."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    thread: int
    ids: Dict[str, Any]


class _Site:
    """One ``with span(...)``: the clock read on entry and exit; on, a frame
    on the thread's stack and a ``Span`` kept at exit. ``t0`` is the entry's
    ``time.perf_counter_ns()``."""

    __slots__ = ("rec", "name", "ids", "t0", "frame")

    def __init__(self, rec: "SpanRecorder", name: str, ids: Dict[str, Any]):
        self.rec, self.name, self.ids, self.frame = rec, name, ids, None

    def __enter__(self) -> "_Site":
        rec = self.rec
        if rec.enabled:
            stack = rec._stack()
            parent, inherited = stack[-1] if stack else (0, {})
            self.frame = (next(rec._next_id), {**inherited, **self.ids}, parent)
            stack.append(self.frame[:2])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        rec, frame = self.rec, self.frame
        with rec._lock:
            total = rec._totals.setdefault(self.name, [0, 0])
            total[0] += t1 - self.t0
            total[1] += 1
            if frame is not None:
                sid, ids, parent = frame
                rec._spans.append(Span(self.name, self.t0 + rec._offset_ns,
                                       t1 + rec._offset_ns, sid, parent,
                                       threading.get_ident(), ids))
        if frame is not None:
            self.frame = None
            rec._stack().pop()


class _Tag:
    """``with spans.tag(**ids)``: spans opened inside inherit ``ids``; no
    span of its own."""

    __slots__ = ("rec", "ids", "pushed")

    def __init__(self, rec: "SpanRecorder", ids: Dict[str, Any]):
        self.rec, self.ids, self.pushed = rec, ids, False

    def __enter__(self) -> None:
        if self.rec.enabled:
            stack = self.rec._stack()
            parent, inherited = stack[-1] if stack else (0, {})
            stack.append((parent, {**inherited, **self.ids}))
            self.pushed = True

    def __exit__(self, *exc) -> None:
        if self.pushed:
            self.pushed = False
            self.rec._stack().pop()


class SpanRecorder:
    """The program's spans (the module's ``spans``). Thread safe: the
    loader's thread records beside the server's."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._spans: List[Span] = []
        self._totals: Dict[str, List[int]] = {}     # name -> [nanoseconds, calls]
        self._next_id = itertools.count(1)
        self._offset_ns = 0

    def _stack(self) -> List:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enable(self) -> None:
        """Keep spans from now on, stamped on the epoch clock: the offset from
        ``perf_counter_ns`` is taken here, so a window's stamps are monotonic."""
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def drain(self) -> List[Span]:
        """The spans kept since the last drain, in the order they ended."""
        with self._lock:
            out, self._spans = self._spans, []
        return out

    def span(self, name: str, **ids) -> _Site:
        return _Site(self, name, ids)

    def tag(self, **ids) -> _Tag:
        return _Tag(self, ids)

    def record(self, name: str, start_s: float, end_s: float, **ids) -> None:
        """A span whose ends were taken elsewhere (``time.perf_counter()``
        seconds), kept only when on and outside the totals: a root on this
        thread (a study's wait, say, which no one call covers)."""
        if self.enabled:
            span = Span(name, int(start_s * 1e9) + self._offset_ns,
                        int(end_s * 1e9) + self._offset_ns, next(self._next_id), 0,
                        threading.get_ident(), ids)
            with self._lock:
                self._spans.append(span)

    def seconds(self, name: str) -> float:
        """The running total of ``name``'s spans, on or off, in seconds."""
        with self._lock:
            return self._totals.get(name, (0, 0))[0] / 1e9

    def totals(self) -> Dict[str, tuple]:
        """{name: (seconds, calls)} of every span site run so far."""
        with self._lock:
            return {k: (ns / 1e9, n) for k, (ns, n) in self._totals.items()}


spans = SpanRecorder()
span = spans.span


def _write_spans(path: str, taken: List[Span]) -> None:
    """Append ``taken`` to the gzipped Chrome trace at ``path`` as complete
    ("X") events of their own process, on the trace's time base."""
    with gzip.open(path, "rt") as fh:
        data = json.load(fh)
    events = data.setdefault("traceEvents", [])
    base = int(data.get("baseTimeNanoseconds", 0))
    pid = 1 + max([e["pid"] for e in events if isinstance(e.get("pid"), int)], default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": SPANS_PROCESS}})
    for s in taken:
        events.append({"ph": "X", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**s.ids, "id": s.id, "parent": s.parent}})
    with gzip.open(path, "wt") as fh:
        json.dump(data, fh)


def capture_trace(fn: Callable[[], object], outdir: str) -> str:
    """Run ``fn`` once under a torch.profiler trace; return the trace
    directory. The card is synchronised before the trace closes, so its
    kernels are in the trace even when ``fn`` returns before they finish.
    With ``spans`` on, the spans taken meanwhile are drained into the trace
    file, as the process ``program spans``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(outdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    on = spans.enabled
    if on:
        spans.drain()
    with profile(activities=activities) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(outdir, f"torch_{time.time_ns()}.trace.json.gz")
    prof.export_chrome_trace(path)
    if on:
        _write_spans(path, spans.drain())
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
    # the program's spans (capture_trace) are host intervals, not operations
    span_pids = {e.get("pid") for e in data.get("traceEvents", [])
                 if e.get("ph") == "M" and e.get("name") == "process_name"
                 and e.get("args", {}).get("name") == SPANS_PROCESS}
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        if (e.get("pid"), e.get("tid")) in step_threads or e.get("pid") in span_pids:
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
