"""The continuous engine: ``decode.continuous.ContinuousServer.serve``, finished
slots refilled every ``seg_steps`` steps, ring caches, captured loop.

Forced lengths reach the fused tail through ``topk_wrapper``, as each slot's
``aux``. The server makes its records only once its loader is exhausted, so
no per-study latency is taken by the benchmark's clock here. Decode steps
issued are the loop's own count since the serve began (``steps_run``).
"""

from __future__ import annotations

from pb import hooks
from pb.serving import KernelCounters, ServingRun


class ContinuousEngine(KernelCounters):
    records_per_batch = False

    def __init__(self, ctx, model, tok, is_forced):
        from evoke_tpu_torch.decode.continuous import ContinuousServer

        dec, eng = ctx.cfg["decode"], ctx.cell["engine_settings"]
        wrapper = hooks.engine_topk_wrapper(dec["beam_size"], tok.eos_id) if is_forced else None
        self.prefetch, self.depth = int(eng["prefetch"]), int(eng["depth"])
        self.server = ContinuousServer(
            model, tok, max_seq_len=ctx.cfg["model"]["max_seq_len"], slots=int(eng["slots"]),
            beam_size=dec["beam_size"], seg_steps=int(eng["seg_steps"]),
            dispatch_segs=int(eng["dispatch_segs"]), pack_batches=int(eng["pack_batches"]),
            suppress_unk=dec["suppress_unk"], length_penalty=dec["length_penalty"],
            topk_wrapper=wrapper, device=ctx.device)
        self.pack_batches = int(eng["pack_batches"])

    def warm(self, stream, with_ind):
        """One pack: the loop, its step graphs and the pack width's heads."""
        self.serve([next(stream) for _ in range(self.pack_batches)], with_ind)

    def serve(self, loader, with_ind):
        records, _ = self.server.serve(loader, prefetch=self.prefetch, depth=self.depth)
        return records

    def steps_issued(self):
        return self.server.loop.steps_run


def run(ctx):
    return ServingRun(ctx, ContinuousEngine).run()
