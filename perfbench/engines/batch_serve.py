"""The batch engine: ``serve.ReportServer.serve``, captured decode loops,
``depth`` batches in flight (what ``cli serve`` runs by default).

Forced lengths reach the fused tail through ``topk_hook``; a decoder whose
steps end in the unfused tail (CMN) is served unforced, since the server
passes no ``logits_hook``. Decode steps issued are read from K1's launch
counter (one launch a layer a step, replays counted), K2's from its own.
"""

from __future__ import annotations

from pb import hooks
from pb.serving import KernelCounters, ServingRun


class BatchServer(KernelCounters):
    records_per_batch = True

    def __init__(self, ctx, model, tok, is_forced):
        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.serve import ReportServer

        dec, eng = ctx.cfg["decode"], ctx.cell["engine_settings"]
        self.layers = ctx.cfg["model"]["num_layers"]
        hook = (hooks.batch_topk_hook(dec["beam_size"], tok.eos_id)
                if is_forced and ctx.cfg["model"]["decoder_kind"] == "r2gen" else None)
        if is_forced and hook is None:
            raise ValueError("forced lengths need the fused tail's hook (R2Gen decoder)")
        self.prefetch = int(eng["prefetch"])
        self.server = ReportServer(
            model, tok, DecodeConfig(beam_size=dec["beam_size"],
                                     suppress_unk=dec["suppress_unk"],
                                     length_penalty=dec["length_penalty"]),
            max_seq_len=ctx.cfg["model"]["max_seq_len"], depth=int(eng["depth"]),
            device=ctx.device, topk_hook=hook)

    def warm(self, stream, with_ind):
        """One batch: the loop of the one batch shape is built and captured."""
        self.server.serve([next(stream)], with_indication=with_ind)

    def serve(self, loader, with_ind):
        return self.server.serve(loader, with_indication=with_ind, prefetch=self.prefetch)

    def steps_issued(self):
        from evoke_tpu_torch.ops.lineage_attention import lineage_attention

        return lineage_attention.launches // self.layers


def run(ctx):
    return ServingRun(ctx, BatchServer).run()
