"""The spans window of a traced run, and what its per-layer metrics read.

The traced window of ``pb/serving.py`` and the measured window run with the
program's span recorder off, so every metric that reads them reads what it
read before the recorder existed. The metrics here read a window of their
own: the first of them to be read builds the cell's server again (weights
from the seed), warms it as ``pb/serving.py`` does (one batch, then the
cell's closed loop for ``warm_seconds``), and serves ``BATCHES`` times
``trace_batches`` batches from a stream of its own under ``pb/trace.traced``
with the recorder on (``evoke_tpu_torch.core.profiling.spans``): the idle
share of 8 batches moves by several points from run to run. Its seconds a
batch and the traced window's (sync to sync on the profiler's clock) go to
stderr side by side, a rough reading of the recorder's cost under the
profiler, with the seconds the window's set-up, serving and reading took. A
program without the recorder gives no window: these metrics read nothing.

Run inside ``pb/serving.ServingRun.run``, on the traced window's server,
the window would cost no second build and warm-up, and its splits would
break down the same server's idle share as ``device_idle_share.serve``.

Each idle stretch of the window's device union is split at the boundaries of
the server's main-thread spans; each piece goes to the innermost span that
covers it, and that span's name to one of ``CATEGORIES`` (``CATEGORY``;
time under no span, or under the root ``serve`` alone, is ``other``). The
six shares sum to the window's idle share.
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pb.common import load_module
from pb.serving import KernelCounters, build_model, count_loader, forced, sync, timed_loader
from pb.tokens import SpelledIds
from pb.trace import Trace, traced

CATEGORIES = ("loader", "stage", "encode", "decode", "records", "other")
CATEGORY = {
    "serve.loader_wait": "loader",
    "serve.stage": "stage", "continuous.fuse": "stage", "continuous.load_pack": "stage",
    "generate.encode": "encode", "continuous.encode": "encode",
    "generate.decode": "decode", "decode.phase": "decode", "decode.flag_read": "decode",
    "continuous.dispatch": "decode",
    "serve.read": "records", "continuous.wait": "records", "continuous.harvest": "records",
    "serve.records": "records",
    "serve": "other",
}
WARM, STREAM = 5, 4    # the generator's streams of the warm-up and the window
BATCHES = 2            # the window's batches, in traced windows (trace_batches)


@dataclass
class SpansWindow:
    trace: Trace
    spans: List              # the program's Span records of the window
    thread: int              # the serving thread


def recorder():
    """The program's span recorder, or None in a program without one."""
    from evoke_tpu_torch.core import profiling

    return getattr(profiling, "spans", None)


def window(ctx) -> Optional[SpansWindow]:
    """The run's spans window, served at the first call (None without a
    traced window or a recorder)."""
    if "spans" not in ctx.extra:
        ctx.extra["spans"] = serve_window(ctx)
    return ctx.extra["spans"]


def engine_server(ctx):
    mod = load_module("engines", ctx.cell["engine"])
    (cls,) = [v for v in vars(mod).values() if isinstance(v, type)
              and issubclass(v, KernelCounters) and v is not KernelCounters]
    return cls


def serve_window(ctx) -> Optional[SpansWindow]:
    rec = recorder()
    if rec is None or ctx.traced is None:
        return None
    cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
    with_ind = bool(traffic.get("with_indication", True))
    gen = ctx.extra["gen"]
    n_traced = int(traffic["trace_batches"])
    n = BATCHES * n_traced
    t0 = time.perf_counter()
    model = build_model(cfg, ctx.seed, dev)
    server = engine_server(ctx)(ctx, model, SpelledIds(cfg["model"]["vocab_size"]),
                                forced(traffic))
    server.warm(gen.stream(ctx.seed, 0, "w"), with_ind)
    warm_s = float(ctx.cell.get("warm_seconds", 0))
    if warm_s > 0:
        server.serve(timed_loader(gen.stream(ctx.seed, WARM, "v"), time.perf_counter() + warm_s,
                                  []), with_ind)
    sync(dev)

    def go():
        server.serve(count_loader(gen.stream(ctx.seed, STREAM, "s"), n, []), with_ind)

    rec.drain()
    rec.enable()
    t1 = time.perf_counter()
    try:
        _, tr = traced(go, dev)
    finally:
        rec.disable()
    taken = rec.drain()
    t2 = time.perf_counter()
    del server, model
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    else:
        # off the card pb/trace's window is on the perf_counter clock; the
        # spans are on the epoch clock
        offset = time.time_ns() - time.perf_counter_ns()
        tr = Trace([], [], (tr.window[0] + offset, tr.window[1] + offset))
    print(f"perfbench: traced windows of {n_traced} / {n} batches, the recorder off / on: "
          f"{ctx.traced.trace.window_s / n_traced:.4f} / {tr.window_s / n:.4f} s a batch; "
          f"the spans window's set-up {t1 - t0:.1f} s, serving and reading its trace "
          f"{t2 - t1:.1f} s", file=sys.stderr)
    return SpansWindow(tr, taken, threading.get_ident())


def innermost(spans: Sequence, thread: int, w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """[w0, w1) cut into (start, end, category) by the innermost categorised
    span of ``thread`` over each piece (nested, as one thread's spans are)."""
    mine = sorted(((s.start_ns, s.end_ns, CATEGORY[s.name]) for s in spans
                   if s.thread == thread and s.name in CATEGORY),
                  key=lambda x: (x[0], -x[1]))
    out: List[Tuple[int, int, str]] = []
    at = w0

    def emit(end, cat):
        nonlocal at
        end = min(end, w1)
        if end > at:
            out.append((at, end, cat))
            at = end

    stack: List[Tuple[int, str]] = []
    for start, end, cat in mine:
        while stack and stack[-1][0] <= start:
            emit(*stack.pop())
        emit(start, stack[-1][1] if stack else "other")
        stack.append((end, cat))
    while stack:
        emit(*stack.pop())
    emit(w1, "other")
    return out


def idle_intervals(trace: Trace) -> List[Tuple[int, int]]:
    w0, w1 = trace.window
    out, at = [], w0
    for s, e in trace.intervals:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if w1 > at:
        out.append((at, w1))
    return out


def idle_split(trace: Trace, spans: Sequence, thread: int) -> Dict[str, float]:
    """Seconds of the window's idle device time in each category."""
    pieces = innermost(spans, thread, *trace.window)
    out = {c: 0 for c in CATEGORIES}
    j = 0
    for s, e in idle_intervals(trace):
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, cat = pieces[k]
            out[cat] += min(b, e) - max(a, s)
            k += 1
    return {c: ns / 1e9 for c, ns in out.items()}


def idle_share(ctx, category: str) -> Optional[float]:
    """% of the spans window in which the card is idle while the server is in
    ``category``."""
    w = window(ctx)
    if w is None or w.trace.window_s <= 0:
        return None
    if "split" not in ctx.extra:
        ctx.extra["split"] = idle_split(w.trace, w.spans, w.thread)
    return 100.0 * ctx.extra["split"][category] / w.trace.window_s


def starts(spans: Sequence, name: str, key: str) -> Dict[int, int]:
    """The first start of ``name``'s spans for each value of its id ``key``."""
    out: Dict[int, int] = {}
    for s in spans:
        if s.name == name and key in s.ids:
            out[s.ids[key]] = min(out.get(s.ids[key], s.start_ns), s.start_ns)
    return out


def queue_wait_ms(ctx) -> Optional[float]:
    """The median over the window's studies of (the start of its batch's
    ``generate.encode``) - (the start of its batch's ``serve.stage``)."""
    w = window(ctx)
    if w is None:
        return None
    staged, encoded = starts(w.spans, "serve.stage", "batch"), starts(
        w.spans, "generate.encode", "batch")
    studies = {s.ids["batch"]: s.ids.get("studies", 1) for s in w.spans
               if s.name == "serve.records" and "batch" in s.ids}
    waits = [(encoded[b] - staged[b]) / 1e6 for b in sorted(staged) if b in encoded
             for _ in range(studies.get(b, 1))]
    return float(np.median(waits)) if waits else None


def admission_wait_p90_ms(ctx) -> Optional[float]:
    """The 90th percentile over the window's studies of ``study.queued``."""
    w = window(ctx)
    if w is None:
        return None
    waits = [(s.end_ns - s.start_ns) / 1e6 for s in w.spans if s.name == "study.queued"]
    return float(np.percentile(waits, 90)) if waits else None
