"""The serving cells' run: set-up, the measured window, the traced window,
then the check of what the window served against the plain reference.

An engine module gives a server class with ``warm(stream)``,
``serve(loader) -> records`` and the counters it reads; this module does the
rest, the same for every serving engine.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Iterator, List

import numpy as np
import torch

from pb import refmodel
from pb.common import Context, Outcome, Served, Study, load_module
from pb.tokens import SpelledIds
from pb.trace import traced
from pb.weights import DTYPES, make_weights

def build_model_and_weights(cfg: Dict, seed: int, device):
    """The configuration's model on ``device``, its weights drawn from the
    seed, and those weights (the benchmark's copy)."""
    from evoke_tpu_torch.models.finetune import FinetuneModel

    m = dict(cfg["model"])
    dtype = DTYPES[cfg["dtype"]]
    with torch.device(device):
        model = FinetuneModel(dtype=dtype, **m)
    weights = make_weights(refmodel.param_spec(m), seed, device, dtype)
    model.load_state_dict(weights, strict=True)
    return model.eval(), weights


def build_model(cfg: Dict, seed: int, device):
    """The configuration's model on ``device``, its weights drawn from the seed."""
    return build_model_and_weights(cfg, seed, device)[0]


def forced(traffic: Dict) -> bool:
    return traffic.get("report_words") is not None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_loader(stream: Iterator[Dict], t_end: float, yielded: List) -> Iterator[Dict]:
    """A closed loop: the next batch whenever the server asks, until the
    window closes. ``yielded`` gets (host clock, batch) for every batch."""
    for bt in stream:
        now = time.perf_counter()
        if now >= t_end:
            return
        yielded.append((now, bt))
        yield bt


def count_loader(stream: Iterator[Dict], n: int, yielded: List) -> Iterator[Dict]:
    for _, bt in zip(range(n), stream):
        yielded.append((time.perf_counter(), bt))
        yield bt


def served_studies(records, yielded, tok: SpelledIds, is_forced: bool):
    """-> (returned studies, attempted, missing, wrong lengths)."""
    wanted = {}
    for _, bt in yielded:
        for j, sid in enumerate(bt["_image_ids"]):
            target = int(bt["target_len"][j]) if is_forced else None
            wanted[sid] = target
    got, wrong = [], 0
    for r in records:
        sid = r["id"]
        if sid not in wanted:
            continue
        toks = tok.tokens(r["report"])
        _, pool, row = sid.split(":")
        target = wanted[sid]
        if target is not None and (len(toks) != target or toks[-1] != tok.eos_id):
            wrong += 1
        got.append(Study(sid, int(pool), int(row), target, toks))
    missing = len(wanted) - len({s.id for s in got})
    return got, len(wanted), missing, wrong


def pick_for_check(studies: List[Study], n: int, seed: int) -> List[Study]:
    """The longest served study and ``n - 1`` others drawn from the seed."""
    if not studies:
        return []
    longest = max(range(len(studies)), key=lambda i: len(studies[i].tokens))
    rest = [i for i in range(len(studies)) if i != longest]
    rng = np.random.default_rng([int(seed), 3])
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [studies[longest]] + [studies[rest[i]] for i in sorted(take)]


def reference_gaps(cfg: Dict, seed: int, device, gen, picked: List[Study],
                   with_indication: bool, control: bool = False) -> Dict[str, Dict]:
    """The widest gap by which a served token's reference logit lies below
    the reference's k-th best at its position (k the beam width: beam search
    serves one of a prefix's k best), over ``picked``; EOS is out of
    contention before a forced end and the forced EOS is not compared, UNK
    is out when suppressed. -> {"program": {"served_gap", "tokens_compared"}},
    and with ``control`` the same numbers under "control" for the float8
    control put in the program's place: it serves each picked study by its
    own beam search, as many tokens as the program compared there, and its
    tokens are read alike."""
    m, dec = cfg["model"], cfg["decode"]
    dtype = DTYPES[cfg["dtype"]]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = {k: v.float() for k, v in make_weights(refmodel.param_spec(m), seed, device,
                                                dtype).items()}
    ref = refmodel.Ref(P, m)
    ctl = refmodel.Ref(P, m, refmodel.fp8_quantizer) if control else None
    tok = SpelledIds(m["vocab_size"])
    k = int(dec["beam_size"])
    out = {"program": {"served_gap": 0.0, "tokens_compared": 0}}
    if control:
        out["control"] = {"served_gap": 0.0, "tokens_compared": 0}

    with torch.no_grad():
        # one study at a time: two picks of one pooled study must not meet as
        # views of one another in the fusion
        for s in picked:
            inputs = {name: torch.as_tensor(v).to(device) for name, v in
                      gen.study_inputs(s.pool, [s.row]).items()}
            n = len(s.tokens) - (1 if s.target is not None else 0)
            if n <= 0:
                continue
            banned = (([tok.unk_id] if dec.get("suppress_unk") else [])
                      + ([tok.eos_id] if s.target is not None else []))
            served = {"program": np.asarray(s.tokens[:n])}
            if ctl is not None:
                served["control"] = refmodel.beam_decode(
                    ctl, refmodel.study_memory(ctl, inputs, with_indication), n, k,
                    tok.bos_id, banned)
            enc = refmodel.study_memory(ref, inputs, with_indication)
            for side, toks in served.items():
                masked = refmodel.report_logits(ref, enc, toks, tok.bos_id)
                masked[:, banned] = -float("inf")
                kth = masked.topk(k, -1).values[:, -1]
                toks = torch.as_tensor(toks, device=masked.device).long()
                gap = (kth - masked.gather(1, toks[:, None])[:, 0]).clamp_min(0)
                out[side]["served_gap"] = max(out[side]["served_gap"], float(gap.max()))
                out[side]["tokens_compared"] += n
    del P, ref, ctl
    return out


def serving_checks(gaps: Dict, failed: int, cell: Dict, traffic: Dict) -> List[tuple]:
    """(name, value, limit, passes) of what a serving run is held to."""
    limit = cell["limits"]["served_gap"]
    least = int(traffic["check_min_tokens"])      # the fewest served tokens compared
    return [("served_gap", gaps["served_gap"], limit, gaps["served_gap"] <= limit),
            ("tokens_compared", gaps["tokens_compared"], least,
             gaps["tokens_compared"] >= least),
            ("reports_failed", failed, 0, failed == 0)]


class KernelCounters:
    """The hand-written kernels' launch counters (replays counted by the
    decode loops' launch ledgers), zeroed before a window."""

    def reset_counters(self):
        from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
        from evoke_tpu_torch.ops.lineage_attention import lineage_attention

        lineage_attention.launches = 0
        fused_logit_topk.launches = 0


class ServingRun:
    """One serving cell's run. ``server_cls(ctx, model, tok, is_forced)`` is
    the engine's adapter."""

    def __init__(self, ctx: Context, server_cls):
        self.ctx, self.server_cls = ctx, server_cls

    def run(self) -> Outcome:
        ctx = self.ctx
        cfg, traffic, dev = ctx.cfg, ctx.traffic, ctx.device
        with_ind = bool(traffic.get("with_indication", True))
        gen = load_module("generators", traffic["generator"]).make(traffic, cfg, ctx.seed)
        ctx.extra["gen"] = gen
        tok = SpelledIds(cfg["model"]["vocab_size"])
        model = build_model(cfg, ctx.seed, dev)
        server = self.server_cls(ctx, model, tok, forced(traffic))
        server.warm(gen.stream(ctx.seed, 0, "w"), with_ind)
        # then the closed loop itself for the cell's warm-up: the first 10-30 s
        # a process serves can run some 7 % slower, and not every process does
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
        sync(dev)
        peak = (torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda"
                else 0)
        del server, model
        gc.collect()
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

        w = ctx.window
        picked = pick_for_check(w.studies, int(traffic["check_studies"]), ctx.seed)
        gaps = reference_gaps(cfg, ctx.seed, dev, gen, picked, with_ind,
                              control=bool(ctx.extra.get("control")))
        ctx.extra["gaps"] = gaps["program"]
        checks = serving_checks(gaps["program"], w.failed, ctx.cell, traffic)
        if "control" in gaps:
            # the control serves every position it is given: no report fails
            ctx.extra["control_checks"] = serving_checks(gaps["control"], 0, ctx.cell, traffic)
        e2e = {"setup_s": setup_s,
               "reports_per_s": len(w.studies) / w.seconds}
        if w.latencies_s:
            e2e["study_latency_p90_ms"] = float(np.percentile(w.latencies_s, 90) * 1e3)
        return Outcome(e2e, checks, w.attempted, w.failed, int(peak))

    def window(self, server, gen, tok, with_ind) -> Served:
        ctx = self.ctx
        yielded: List = []
        done: List[float] = []
        server.reset_counters()
        tok.on_batch = done.append
        t0 = time.perf_counter()
        records = server.serve(timed_loader(gen.stream(ctx.seed, 1, "b"), t0 + ctx.seconds,
                                            yielded), with_ind)
        sync(ctx.device)
        secs = time.perf_counter() - t0
        tok.on_batch = None
        got, attempted, missing, wrong = served_studies(records, yielded, tok,
                                                        forced(ctx.traffic))
        latencies: List[float] = []
        if server.records_per_batch and len(done) == len(yielded):
            for (t_in, bt), t_out in zip(yielded, done):
                latencies += [t_out - t_in] * len(bt["_image_ids"])
        return Served(secs, attempted, got, missing + wrong, latencies,
                      server.steps_issued())
