"""The batch engine (``serve.ReportServer``, captured decode loops, ``depth``
batches in flight) serving a configuration whose report decoder is a large
language model (``decoder_kind`` ``mla_moe``), checked against
``pb/ref_mla_moe.py``.

``pb/serving.ServingRun`` builds the model and the reference of
``pb/refmodel.py``; this engine runs the same window from ``pb/serving``'s
parts with three differences. The model is built on the meta device and
takes the seeded weights as its own (``load_state_dict(assign=True)``), so the
~32 GB of weights are held once. The spans window (``pb/spans.py``) is served
by the same server after the traced window, so no second model is built.
The language model's expert ledger (rows routed to each expert, experts
touched) is zeroed with the kernel counters and read after the traced
window (``ctx.extra["expert_ledger"]``). Forced lengths reach the fused tail
through ``topk_hook``; decode steps issued are K2's launches (one a step).
"""

from __future__ import annotations

import gc
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from pb import hooks, ref_mla_moe, spans
from pb.common import Outcome, Served, load_module
from pb.serving import (KernelCounters, ServingRun, count_loader, forced, pick_for_check,
                        served_studies, serving_checks, sync, timed_loader)
from pb.tokens import SpelledIds
from pb.trace import Trace, traced
from pb.weights import DTYPES


def build_model(cfg, seed: int, device):
    """The configuration's model on ``device`` holding the weights drawn
    from the seed (``ref_mla_moe.make_weights``) as its own tensors."""
    from evoke_tpu_torch.models.finetune import FinetuneModel

    dtype = DTYPES[cfg["dtype"]]
    with torch.device("meta"):
        model = FinetuneModel(dtype=dtype, **ref_mla_moe.model_kwargs(cfg))
    model.load_state_dict(ref_mla_moe.make_weights(cfg, seed, device, dtype), strict=True,
                          assign=True)
    left = [n for n, t in list(model.named_parameters()) + list(model.named_buffers())
            if t.is_meta]
    if left:
        raise RuntimeError(f"no weights for {left[:4]}")
    return model.eval()


class LMBatchServer(KernelCounters):
    records_per_batch = True

    def __init__(self, ctx, model, tok, is_forced):
        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.serve import ReportServer

        dec, eng = ctx.cfg["decode"], ctx.cell["engine_settings"]
        self.decoder = model.text_decoder
        self.prefetch = int(eng["prefetch"])
        self.server = ReportServer(
            model, tok, DecodeConfig(beam_size=dec["beam_size"],
                                     suppress_unk=dec["suppress_unk"],
                                     length_penalty=dec["length_penalty"]),
            max_seq_len=ctx.cfg["model"]["max_seq_len"], depth=int(eng["depth"]),
            device=ctx.device,
            topk_hook=hooks.batch_topk_hook(dec["beam_size"], tok.eos_id) if is_forced else None)

    def reset_counters(self):
        super().reset_counters()
        self.decoder.reset_expert_ledger()

    def warm(self, stream, with_ind):
        """One batch: the loop of the one batch shape is built and captured."""
        self.server.serve([next(stream)], with_indication=with_ind)

    def serve(self, loader, with_ind):
        return self.server.serve(loader, with_indication=with_ind, prefetch=self.prefetch)

    def steps_issued(self):
        from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk

        return fused_logit_topk.launches


class LMServingRun(ServingRun):
    def run(self) -> Outcome:
        ctx = self.ctx
        cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
        with_ind = bool(traffic.get("with_indication", True))
        gen = load_module("generators", traffic["generator"]).make(traffic, cfg, ctx.seed)
        ctx.extra["gen"] = gen
        tok = SpelledIds(cfg["model"]["vocab_size"])
        model = build_model(cfg, ctx.seed, dev)
        server = LMBatchServer(ctx, model, tok, forced(traffic))
        server.warm(gen.stream(ctx.seed, 0, "w"), with_ind)
        warm_s = float(ctx.cell.get("warm_seconds", 0))
        if warm_s > 0:
            server.serve(timed_loader(gen.stream(ctx.seed, 3, "u"), time.perf_counter() + warm_s,
                                      []), with_ind)
        sync(dev)
        setup_s = time.perf_counter() - ctx.t_start

        ctx.window = self.window(server, gen, tok, with_ind)
        if ctx.trace:
            yielded: List = []
            records = None

            def go():
                nonlocal records
                records = server.serve(count_loader(gen.stream(ctx.seed, 2, "t"),
                                                    int(traffic["trace_batches"]), yielded),
                                       with_ind)
            server.reset_counters()
            t0 = time.perf_counter()
            _, tr = traced(go, dev)
            secs = time.perf_counter() - t0
            got, attempted, missing, wrong = served_studies(records, yielded, tok,
                                                            forced(traffic))
            ctx.traced = Served(secs, attempted, got, missing + wrong,
                                steps_issued=server.steps_issued(), trace=tr)
            ctx.extra["expert_ledger"] = model.text_decoder.read_expert_ledger()
            ctx.extra["spans"] = spans_window(ctx, server, gen, with_ind)
        sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda"
                else 0)
        del server, model
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

        w = ctx.window
        picked = pick_for_check(w.studies, int(traffic["check_studies"]), ctx.seed)
        gaps = ref_mla_moe.reference_gaps(cfg, ctx.seed, dev, gen, picked, with_ind,
                                          control=bool(ctx.extra.get("control")))
        ctx.extra["gaps"] = gaps["program"]
        checks = serving_checks(gaps["program"], w.failed, ctx.cell, traffic)
        if "control" in gaps:
            ctx.extra["control_checks"] = serving_checks(gaps["control"], 0, ctx.cell, traffic)
        e2e = {"setup_s": setup_s, "reports_per_s": len(w.studies) / w.seconds}
        if w.latencies_s:
            e2e["study_latency_p90_ms"] = float(np.percentile(w.latencies_s, 90) * 1e3)
        return Outcome(e2e, checks, w.attempted, w.failed, int(peak))


def spans_window(ctx, server, gen, with_ind):
    """``pb/spans.serve_window``'s window on this run's own server (already
    warm): ``BATCHES`` x ``trace_batches`` batches under the profiler with the
    program's span recorder on. None in a program without the recorder."""
    rec = spans.recorder()
    if rec is None:
        return None
    dev = ctx.device
    n = spans.BATCHES * int(ctx.traffic["trace_batches"])

    def go():
        server.serve(count_loader(gen.stream(ctx.seed, spans.STREAM, "s"), n, []), with_ind)

    rec.drain()
    rec.enable()
    t1 = time.perf_counter()
    try:
        _, tr = traced(go, dev)
    finally:
        rec.disable()
    taken = rec.drain()
    if torch.device(dev).type != "cuda":
        # off the card pb/trace's window is on the perf_counter clock; the spans
        # are on the epoch clock
        offset = time.time_ns() - time.perf_counter_ns()
        tr = Trace([], [], (tr.window[0] + offset, tr.window[1] + offset))
    print(f"perfbench: spans window of {n} batches on the traced window's server, serving "
          f"and reading its trace {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return spans.SpansWindow(tr, taken, threading.get_ident())


def run(ctx):
    return LMServingRun(ctx, LMBatchServer).run()
