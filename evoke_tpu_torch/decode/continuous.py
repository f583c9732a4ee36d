"""Continuous-batching beam serving: finished slots refilled mid-stream (port
of evoke_tpu/decode/continuous.py).

The batch engine (serve.ReportServer) decodes a batch until its slowest
study finishes. This engine keeps the decode batch full instead: every
``seg_steps`` steps it harvests the slots whose beams have all finished and
admits queued studies into them, so the loop pays about the mean report
length rather than the longest in a batch.

Ring caches, as in JAX: every row writes its step's K/V at the same physical
slot ``p = t mod L`` and each slot remembers where its logical position 0 lives
(``base``); a row of age ``a`` reads physical slot j iff (p - j) mod L <= a
(models/layers.py ``cached_self_attention``; with an ancestor table the
lineage kernel's ring mode). Admission resets a slot's bookkeeping, its
relational memory and its cross K/V and mask; the [N, L, D] caches are never
cleared (stale slots are unreadable at age 0).

``ContinuousLoop`` is the engine core, written as ``decode/beam.BeamLoop``
is: the carry, the decode state and one admission pack per pack width live in
buffers allocated once, and ``harvest``, ``admit`` and ``one_step(p)`` write
into them in place. On a CUDA device one graph per ring position ``p`` (the
step; ``p`` is a Python number in it) and one per segment of a dispatch (harvest
and admit) are captured into one private pool and replayed; the host writes
the pack's available rows and the reset flag into device scalars before each
dispatch and copies a new pack into the pack buffers, all on the stream, so a
dispatch already queued never sees what the next one is given. On the CPU the
same code runs eagerly. ``ContinuousServer`` is the host side.

Spans (``core/profiling``): ``serve``, ``serve.loader_wait``,
``serve.stage`` and ``serve.records`` as in ``serve.ReportServer``;
``continuous.encode`` (a batch's encoder, ``batch``), ``continuous.fuse``
and ``continuous.load_pack`` (``pack``), ``continuous.dispatch``,
``continuous.wait`` and ``continuous.harvest`` (``dispatch``); and for each
study (``ticket``) ``study.queued`` (its batch encoded -> its admission
dispatch) and ``study.decoding`` (-> the read of its harvest).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from evoke_tpu_torch.core.profiling import span, spans
from evoke_tpu_torch.decode.beam import (NEG_INF, LaunchLedger, _leaves, _tree_map,
                                         advance_state, capture_graph, penalty_fn,
                                         side_stream)
from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index as topk
from evoke_tpu_torch.ops.lineage_attention import lineage_attention

# step signature: (tok [N], p (Python int), age_rows [N], dec, att_mask [B, P],
#                  aux [B]) -> (raw logits [N, V] or the fused triple, new dec)
ContinuousStepFn = Callable


class SegmentOutputs(NamedTuple):
    """One segment's harvest and admission report, slot-indexed (views of the
    loop's output buffers: valid until the next dispatch writes them)."""

    harvested: torch.Tensor   # [B] bool: the slot finished and was freed
    tickets: torch.Tensor     # [B] int32: ticket of the study the slot held
    seqs: torch.Tensor        # [B, k, L]: logical order, best first, PAD after EOS
    scores: torch.Tensor      # [B, k] float32: length-penalised log-probs
    n_admitted: torch.Tensor  # [] int32: pack rows admitted
    host_meta: torch.Tensor   # [B + 1, 2] int32: rows 0..B-1 (harvested, ticket);
    #                           row B (n_admitted, pack_pos after admission)
    best_seq: torch.Tensor    # [B, L] int32: seqs[:, 0], the emitted report


class ContinuousLoop:
    """Harvest -> admit -> ``seg_steps`` beam steps, ``dispatch_segs``
    segments per ``dispatch``, over ``slots`` studies x ``beam_size`` beams.

    ``dec0``: the decode state of ``slots * beam_size`` rows from the model's
    ``init_decode_state`` at ``max_len`` (its caches become the ring buffers;
    'cross_k' / 'cross_v' are slot-level [slots, P, D] and overwritten per
    admission; 'memory' is the admission reset template; an 'anc' [slots, k,
    L] int32 table selects ancestor mode). ``att_mask0`` [slots, P] should be
    all ones (inactive slots then attend finite K/V). All slots start inactive
    with every beam finished, so they are never harvested.

    ``fused_topk``: ``step`` returns the fused vocab tail's (vals [N, k],
    idx [N, k], lse [N]) with suppression inside, so ``suppress_ids`` must be
    empty; else it returns raw logits [N, V] (two-stage exact top-k, lse from
    the logits before suppression).

    ``graphs`` (default: on a CUDA device): the steps and the segment heads
    are captured and replayed (a capture or replay error raises; it is never
    retried eagerly); ``graphs=False`` runs them eagerly. The step must find
    what it reads besides its arguments (weights) at the addresses it had at
    construction."""

    @torch.inference_mode()
    def __init__(self, step: ContinuousStepFn, dec0, att_mask0, *, slots: int,
                 beam_size: int, seg_steps: int, bos_id: int, eos_id: int, pad_id: int,
                 max_len: int, length_penalty: str = "",
                 suppress_ids: Tuple[int, ...] = (), fused_topk: bool = False,
                 dispatch_segs: int = 1, graphs: Optional[bool] = None):
        if fused_topk and suppress_ids:
            raise ValueError("fused_topk steps suppress inside the kernel; pass suppress_ids=()")
        if not isinstance(dec0, dict) or not {"cache_k", "cache_v", "memory"} <= set(dec0):
            raise TypeError("ContinuousLoop needs a dict decode state with 'cache_k' / "
                            "'cache_v' [N, L, D] caches and a 'memory' entry")
        self.step = step
        self.b, self.k, self.n = slots, beam_size, slots * beam_size
        self.seg_steps, self.segs = int(seg_steps), max(int(dispatch_segs), 1)
        self.bos_id, self.eos_id, self.pad_id, self.max_len = bos_id, eos_id, pad_id, max_len
        self.lp = penalty_fn(length_penalty)
        self.suppress_ids, self.fused_topk = tuple(suppress_ids), fused_topk
        self.ancestor_kv = "anc" in dec0
        dev = self.device = _leaves(dec0["cache_k"])[0].device
        if any(c.shape[1] != max_len for c in _leaves(dec0["cache_k"]) + _leaves(dec0["cache_v"])):
            raise ValueError(f"dec0's caches must have length max_len = {max_len}")
        self.graphs = dev.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and dev.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, got {dev}")

        b, k, n, r, L = self.b, self.k, self.n, self.segs, max_len
        i32, i64 = torch.int32, torch.long
        # the decode state and the attention mask the step reads
        self.dec = {key: _tree_map(torch.empty_like, v) for key, v in dec0.items()}
        self.att_mask = torch.empty_like(att_mask0)
        # what init_carry restores: the caches and the ancestor table are zeroed
        self._dec0 = {key: _tree_map(torch.clone, v) for key, v in dec0.items()
                      if key not in ("cache_k", "cache_v", "anc")}
        self._att_mask0 = att_mask0.clone()
        self.memory0 = self._dec0["memory"]
        # the carry
        self.t = torch.empty((), dtype=i64, device=dev)
        self.pack_pos = torch.empty((), dtype=i64, device=dev)
        self.age = torch.empty(b, dtype=i32, device=dev)
        self.base = torch.empty(b, dtype=i32, device=dev)
        self.active = torch.empty(b, dtype=torch.bool, device=dev)
        self.ticket = torch.empty(b, dtype=i32, device=dev)
        self.aux = torch.empty(b, dtype=i32, device=dev)
        self.tok = torch.empty(n, dtype=i64, device=dev)
        self.alive = torch.empty(b, k, device=dev)
        self.seq = torch.empty(b, k, L, dtype=i64, device=dev)
        self.done_seq = torch.empty_like(self.seq)
        self.done_score = torch.empty(b, k, device=dev)
        self.ever_fin = torch.empty(b, k, dtype=torch.bool, device=dev)
        # what the host writes before each dispatch
        self.pack_avail = torch.zeros((), dtype=i64, device=dev)
        self.reset_pos = torch.zeros((), dtype=torch.bool, device=dev)
        # each segment's outputs
        self.host_meta = torch.zeros(r, b + 1, 2, dtype=i32, device=dev)
        self.best_seq = torch.zeros(r, b, L, dtype=i32, device=dev)
        self.out_seqs = torch.zeros(r, b, k, L, dtype=i64, device=dev)
        self.out_scores = torch.zeros(r, b, k, device=dev)
        # constants of every step
        self._row0 = (torch.arange(b, device=dev) * k)[:, None]
        self._later_beams = torch.arange(k, device=dev)[None, :, None] > 0
        self._positions = torch.arange(L, device=dev)

        self.packs: Dict[int, Dict[str, Any]] = {}   # pack rows E -> pack buffers
        self.pack: Optional[Dict[str, Any]] = None
        self.t_host = 0          # the device's t, known on the host
        self.steps_run = 0       # steps queued since the last init_carry
        self.capture_s = 0.0
        self._steps: List = []
        self._heads: Dict[int, List] = {}
        self._pool = None
        self._ledger = LaunchLedger((lineage_attention, fused_logit_topk))
        self.init_carry()
        if self.graphs:
            self._capture_steps()
            self.init_carry()    # undo the eager warm-up

    @torch.inference_mode()
    def init_carry(self) -> None:
        """Every slot inactive with every beam finished; caches and ancestor
        table zero; t and the pack offset 0."""
        for key, buf in self.dec.items():
            if key in self._dec0:
                _tree_map(lambda dst, src: dst.copy_(src), buf, self._dec0[key])
            else:
                for leaf in _leaves(buf):
                    leaf.zero_()
        self.att_mask.copy_(self._att_mask0)
        self.t.zero_()
        self.pack_pos.zero_()
        self.age.zero_()
        self.base.zero_()
        self.active.zero_()
        self.ticket.fill_(-1)
        self.aux.zero_()
        self.tok.fill_(self.bos_id)
        self.alive.zero_()
        self.seq.fill_(self.pad_id)
        self.done_seq.fill_(self.pad_id)
        self.done_score.fill_(NEG_INF)
        self.ever_fin.fill_(True)
        self.t_host = 0
        self.steps_run = 0

    def _pack_buffers(self, e: int) -> Dict[str, Any]:
        def rows(x):
            return x.new_empty((e,) + tuple(x.shape[1:]))

        return {"cross_k": _tree_map(rows, self.dec["cross_k"]),
                "cross_v": _tree_map(rows, self.dec["cross_v"]),
                "att_mask": rows(self.att_mask),
                "ticket": torch.zeros(e, dtype=torch.int32, device=self.device),
                "aux": torch.zeros(e, dtype=torch.int32, device=self.device)}

    @torch.inference_mode()
    def load_pack(self, pack: Dict[str, Any]) -> None:
        """Copy ``pack`` ({'cross_k', 'cross_v': tuples of [E, P, D],
        'att_mask' [E, P], 'ticket' [E] int32, 'aux' [E] int32}) into the
        pack buffers of its width E (made, and on the card their segment
        heads captured, at E's first pack). Rows ``pack_pos..avail-1`` are
        admitted FIFO by the dispatches after this call."""
        e = int(pack["att_mask"].shape[0])
        if e not in self.packs:
            self.packs[e] = self._pack_buffers(e)
            if self.graphs:
                self._capture_heads(e)
        bufs = self.packs[e]
        for key in ("cross_k", "cross_v", "att_mask", "ticket", "aux"):
            _tree_map(lambda dst, src: dst.copy_(src), bufs[key], pack[key])
        self.pack = bufs

    def harvest(self, j: int) -> None:
        """Segment ``j``'s harvest: slots whose beams have all finished are
        freed; their done buffers, unrolled from the ring (``base``) to logical
        order with PAD after the first EOS, go to output row ``j``."""
        b, k, L = self.b, self.k, self.max_len
        harvested = self.ever_fin.all(1) & self.active
        idx = torch.remainder(self.base.long()[:, None] + self._positions[None, :], L)
        seqs = self.done_seq.gather(2, idx[:, None, :].expand(b, k, L))
        is_eos = seqs == self.eos_id
        first_eos = torch.where(is_eos.any(-1), is_eos.int().argmax(-1), L)
        seqs = torch.where(self._positions > first_eos[:, :, None], self.pad_id, seqs)
        meta = self.host_meta[j]
        meta[:b, 0].copy_(harvested)
        meta[:b, 1].copy_(self.ticket)
        self.out_seqs[j].copy_(seqs)
        self.out_scores[j].copy_(self.done_score)
        self.best_seq[j].copy_(seqs[:, 0])
        self.active.copy_(self.active & ~harvested)

    def admit(self, j: int, first: bool) -> None:
        """Segment ``j``'s admission: free slots take the pack's next rows in
        FIFO order, up to ``pack_avail``; the offset starts at 0 when the
        host raised ``reset_pos`` for this dispatch (``first``: the dispatch's
        first segment). Admission resets the slot's bookkeeping and memory and
        takes its cross K/V and mask from the pack row; the caches are never
        cleared."""
        k = self.k
        pack = self.pack
        e = pack["att_mask"].shape[0]
        offset = torch.where(self.reset_pos, 0, self.pack_pos) if first else self.pack_pos
        free = ~self.active
        free_rank = torch.cumsum(free.long(), 0) - 1
        n_avail = (self.pack_avail - offset).clamp_min(0)
        admitted = free & (free_rank < n_avail)
        n_admitted = admitted.sum()
        src = (offset + free_rank).clamp(0, e - 1)
        adm_rows = admitted.repeat_interleave(k)

        def slot_sel(dst, rows):
            m = admitted.reshape((-1,) + (1,) * (dst.dim() - 1))
            dst.copy_(torch.where(m, rows.index_select(0, src), dst))

        for key in ("cross_k", "cross_v"):
            _tree_map(slot_sel, self.dec[key], pack[key])
        slot_sel(self.att_mask, pack["att_mask"])
        slot_sel(self.ticket, pack["ticket"])
        slot_sel(self.aux, pack["aux"])
        mem = self.dec["memory"]
        mem.copy_(torch.where(adm_rows[:, None], self.memory0, mem))
        self.base.copy_(torch.where(admitted, torch.remainder(self.t, self.max_len), self.base))
        self.age.masked_fill_(admitted, 0)
        self.active.copy_(self.active | admitted)
        self.tok.masked_fill_(adm_rows, self.bos_id)
        self.alive.masked_fill_(admitted[:, None], 0.0)
        self.seq.masked_fill_(admitted[:, None, None], self.pad_id)
        self.done_seq.masked_fill_(admitted[:, None, None], self.pad_id)
        self.done_score.masked_fill_(admitted[:, None], NEG_INF)
        self.ever_fin.masked_fill_(admitted[:, None], False)
        self.pack_pos.copy_(offset + n_admitted)
        meta = self.host_meta[j]
        meta[self.b, 0].copy_(n_admitted)
        meta[self.b, 1].copy_(self.pack_pos)
        self.t.add_(self.seg_steps)     # nothing of this segment reads t after admission

    def one_step(self, p: int) -> None:
        """One beam step of every slot at physical ring slot ``p``, in place."""
        b, k, n, L = self.b, self.k, self.n, self.max_len
        age = self.age
        frozen_now = self.ever_fin.all(1)
        age_rows = age.repeat_interleave(k)
        if self.fused_topk:
            (vals, tok_cand, lse), new_dec = self.step(self.tok, p, age_rows, self.dec,
                                                       self.att_mask, self.aux)
        else:
            logits, new_dec = self.step(self.tok, p, age_rows, self.dec, self.att_mask,
                                        self.aux)
            lse = torch.logsumexp(logits.float(), dim=-1)
            for sid in self.suppress_ids:
                logits[:, sid] += -1000.0
            vals, tok_cand = topk(logits, k)
        logp_cand = vals.float() - lse[:, None]
        cand = (self.alive.reshape(n)[:, None] + logp_cand).reshape(b, k, k)
        # a slot at age 0 holds BOS copies: keep only beam 0's candidates
        cand = torch.where((age == 0)[:, None, None] & self._later_beams, NEG_INF, cand)
        scores, flat_idx = topk(cand.reshape(b, k * k), k)
        beam_idx = flat_idx // k
        tok_idx = tok_cand.reshape(b, k * k).long().gather(1, flat_idx)

        seq = self.seq.gather(1, beam_idx[:, :, None].expand(-1, -1, L))
        seq[:, :, p] = tok_idx
        advance_state(self.dec, new_dec, beam_idx, self._row0, p, self.ancestor_kv)

        finished = (tok_idx == self.eos_id) | (age == L - 1)[:, None]
        length = (age + 1).float()[:, None]
        live = self.active & ~frozen_now
        fin_score = torch.where(finished & live[:, None], self.lp(length, scores), NEG_INF)
        all_scores = torch.cat([self.done_score, fin_score], dim=1)
        all_seqs = torch.cat([self.done_seq, seq], dim=1)
        top_scores, top_idx = topk(all_scores, k)
        done_seq = all_seqs.gather(1, top_idx[:, :, None].expand(-1, -1, L))

        self.ever_fin.copy_(self.ever_fin.gather(1, beam_idx) | finished)
        self.age.copy_((age + 1).clamp_max(L - 1))
        self.tok.copy_(tok_idx.reshape(n))
        self.alive.copy_(scores - 1000.0 * finished.float())
        self.seq.copy_(seq)
        self.done_seq.copy_(done_seq)
        self.done_score.copy_(top_scores)

    @torch.inference_mode()
    def dispatch(self, pack_avail: int, reset_pos: bool) -> None:
        """Queue ``dispatch_segs`` segments: each harvests, admits from the
        loaded pack (rows below ``pack_avail``; the first segment restarts at
        row 0 when ``reset_pos``) and runs ``seg_steps`` steps. Nothing is
        read back; the outputs land in ``host_meta`` / ``best_seq``."""
        if self.pack is None:
            raise RuntimeError("ContinuousLoop.dispatch: load_pack() a pack first")
        self.pack_avail.fill_(int(pack_avail))
        self.reset_pos.fill_(bool(reset_pos))
        e = int(self.pack["att_mask"].shape[0])
        for j in range(self.segs):
            if self.graphs:
                self._heads[e][j].replay()
                self._ledger.replayed(("head", e, j))
            else:
                self.harvest(j)
                self.admit(j, j == 0)
            for i in range(self.seg_steps):
                p = (self.t_host + i) % self.max_len
                if self.graphs:
                    self._steps[p].replay()
                    self._ledger.replayed(("step", p))
                else:
                    self.one_step(p)
            self.t_host += self.seg_steps
        self.steps_run += self.segs * self.seg_steps

    def outputs(self, j: int = 0) -> SegmentOutputs:
        meta = self.host_meta[j]
        return SegmentOutputs(harvested=meta[:self.b, 0].bool(), tickets=meta[:self.b, 1],
                              seqs=self.out_seqs[j], scores=self.out_scores[j],
                              n_admitted=meta[self.b, 0], host_meta=meta,
                              best_seq=self.best_seq[j])

    def _capture_steps(self) -> None:
        """An eager segment head (over a one-row pack that admits nothing)
        and step on a side stream first (each kernel's first launch, the
        libraries' workspaces), then one graph per ring position, all in one
        private pool."""
        t0 = time.perf_counter()
        side = side_stream(self.device)
        with torch.cuda.stream(side):
            self.pack = self._pack_buffers(1)
            self.harvest(0)
            self.admit(0, True)
            self.one_step(0)
            self.pack = None
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._pool = torch.cuda.graph_pool_handle()
        for p in range(self.max_len):
            self._steps.append(capture_graph(self._ledger, ("step", p),
                                             lambda p=p: self.one_step(p), self._pool, side))
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0

    def _capture_heads(self, e: int) -> None:
        """The segment heads (harvest + admit) of pack width ``e``: one graph
        per segment of a dispatch (each writes its own output row)."""
        t0 = time.perf_counter()
        side = side_stream(self.device)
        pack, self.pack = self.pack, self.packs[e]
        heads = []
        for j in range(self.segs):
            def head(j=j):
                self.harvest(j)
                self.admit(j, j == 0)

            heads.append(capture_graph(self._ledger, ("head", e, j), head, self._pool, side))
        self.pack = pack
        self._heads[e] = heads
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0


class _HostReads:
    """Each dispatch's ``host_meta`` / ``best_seq`` copied to the host without
    blocking: on the card into a ring of ``depth`` pinned buffer pairs, one
    CUDA event each (a slot is read before it is reused); on the CPU a plain
    copy."""

    def __init__(self, loop: ContinuousLoop, depth: int):
        self.loop = loop
        cuda = loop.device.type == "cuda"
        self.slots = [(torch.empty(loop.host_meta.shape, dtype=torch.int32, pin_memory=cuda),
                       torch.empty(loop.best_seq.shape, dtype=torch.int32, pin_memory=cuda),
                       torch.cuda.Event() if cuda else None) for _ in range(depth)]
        self.next = 0

    def issue(self) -> int:
        meta, best, event = self.slots[self.next]
        meta.copy_(self.loop.host_meta, non_blocking=True)
        best.copy_(self.loop.best_seq, non_blocking=True)
        if event is not None:
            event.record()
        slot, self.next = self.next, (self.next + 1) % len(self.slots)
        return slot

    def wait(self, slot: int) -> Tuple[np.ndarray, np.ndarray]:
        meta, best, event = self.slots[slot]
        if event is not None:
            event.synchronize()
        return meta.numpy(), best.numpy()


class ContinuousServer:
    """The host side: loader batches -> encoded packs -> dispatches -> records.

    The record contract of serve.ReportServer (``{'id', 'report'[, 'gt']}``,
    in ticket order, i.e. loader order) with the decode batch kept full across
    study boundaries. The host encodes pending studies, switches packs and
    reads each dispatch's harvest report; slot scheduling runs on the device.

    ``step_wrapper(raw_step) -> step`` (same signature as ``raw_step(tok, p,
    age_rows, dec, att_mask, aux)``) rewrites the raw logits, so it keeps the
    unfused tail, unless ``topk_wrapper(vals, idx, lse, age_rows, aux) ->
    (vals, idx)`` is also given: that rewrites the fused tail's [N, k]
    candidates, and the step_wrapper is then ignored (the load-testing hooks
    of the JAX package; a loader batch's host ``_aux`` [E] int32 reaches the
    step as ``aux``, per slot).

    ``mesh`` (a pure-dp ``core/mesh.Mesh``; the device is then the rank's):
    the slots shard over dp (``slots % dp == 0``, as JAX asserts). Each rank
    runs its own engine, ring caches and CUDA graphs over ``slots / dp``
    slots, fed with its rows of every loader batch (K1 in ring mode and K2
    at its rows); the encoder gathers the visual features across ranks, one
    gather per loader batch in loader order on every rank. A study's report
    does not depend on its slot, so the reports are the one-device engine's;
    they are gathered from every rank at the end, in loader order. Under a
    dp x mp mesh the model is sharded over mp (``parallel/tp.py``): the
    ring caches hold the rank's ``D / mp``, K1 and K2 are declined (reorder
    ring caches, the unfused tail), the steps hold mp collectives and run
    eagerly (``graphs=True`` raises; ``stats["captured"]`` says which), and
    the records are gathered from the ``mp_rank`` 0 rank of each dp group."""

    def __init__(self, model, tokenizer, *, max_seq_len: int = 100, slots: int = 64,
                 beam_size: int = 3, seg_steps: int = 10, dispatch_segs: int = 4,
                 pack_batches: int = 4, suppress_unk: bool = False,
                 length_penalty: str = "", step_wrapper=None, topk_wrapper=None,
                 beam_kv: str = "auto", kv_cache_dtype: str = "", device="cuda",
                 graphs: Optional[bool] = None, mesh=None):
        """``graphs``: None captures the loop into CUDA graphs on a CUDA
        device and runs it eagerly on the CPU; False runs it eagerly on
        either (an A/B on the card)."""
        if getattr(model, "decoder_kind", "r2gen") != "r2gen":
            raise NotImplementedError(
                "continuous serving needs ring-cache (age-aware) decode steps; only the "
                f"R2Gen decoder implements them (decoder_kind={model.decoder_kind!r}): "
                "use the batch engine")
        if kv_cache_dtype:
            raise NotImplementedError(
                f"kv_cache_dtype={kv_cache_dtype!r} is not supported by the continuous "
                "engine (ring caches in the model dtype only): use the batch engine")
        from types import SimpleNamespace

        from evoke_tpu_torch.core.device import resolve_device
        from evoke_tpu_torch.ops.fused_logit_topk import use_fused_logit_topk
        from evoke_tpu_torch.ops.sharding import check_divisible
        from evoke_tpu_torch.train.steps import check_tp, resolve_beam_kv

        self.mesh = mesh
        if mesh is not None:
            check_divisible(slots, mesh, "decode.slots")
            check_tp(model, mesh)
            if mesh.mp > 1:
                if graphs:
                    raise ValueError(f"graphs=True with mp={mesh.mp}: the decode steps hold "
                                     "mp collectives, which are not captured (ROADMAP C9)")
                graphs = False
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.ancestor_kv = resolve_beam_kv(SimpleNamespace(beam_kv=beam_kv),
                                           serving=True, mesh=mesh) == "ancestor"
        self.model, self.tokenizer = model, tokenizer
        self.max_len = max_seq_len
        # this rank's slots
        slots = slots if mesh is None else slots // mesh.dp
        self.slots, self.k, self.seg_steps = slots, beam_size, seg_steps
        self.dispatch_segs = max(int(dispatch_segs), 1)
        # admission looks ahead depth * dispatch_segs segments (the host learns
        # consumption only from lagged reads), more than one loader batch feeds:
        # pack_batches loader batches are fused into one pack so pack switches
        # stay rare against that lookahead
        self.pack_batches = max(int(pack_batches), 1)
        self._max_partners = getattr(model, "fusion_max_partners", None)
        suppress = (tokenizer.unk_id,) if suppress_unk else ()
        self.fused_topk = fused = (use_fused_logit_topk(model, True, mesh=mesh)
                                   and (step_wrapper is None or topk_wrapper is not None))

        def raw_step(tok, p, age_rows, dec, att_mask, aux):
            if fused:
                out, dec2 = model.decode_step(tok, p, dec, att_mask, return_topk=beam_size,
                                              topk_suppress=suppress, age=age_rows)
                if topk_wrapper is not None:
                    vals, idx, lse = out
                    vals, idx = topk_wrapper(vals, idx, lse, age_rows, aux)
                    out = (vals, idx, lse)
                return out, dec2
            return model.decode_step(tok, p, dec, att_mask, return_logits=True, age=age_rows)

        self._step = step_wrapper(raw_step) if step_wrapper and not fused else raw_step
        self._loop_kw = dict(
            slots=slots, beam_size=beam_size, seg_steps=seg_steps,
            bos_id=tokenizer.bos_id, eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id,
            max_len=max_seq_len, length_penalty=length_penalty,
            suppress_ids=() if fused else suppress, fused_topk=fused,
            dispatch_segs=self.dispatch_segs, graphs=graphs)
        self.loop: Optional[ContinuousLoop] = None
        self.captured = self.device.type == "cuda" and graphs is not False
        self.stats: Dict[str, float] = {}

    @torch.inference_mode()
    def encode_pack(self, batch) -> Dict[str, Any]:
        """A device loader batch -> {'cross_k', 'cross_v', 'att_mask'}: the
        encoder and each decoder layer's cross K/V, one row per anchor."""
        from evoke_tpu_torch.core.mesh import use_mesh
        from evoke_tpu_torch.train.steps import maybe_normalize_images

        batch = maybe_normalize_images(batch)
        e = batch["ids"].shape[0]
        inc = [batch["inc_ids"], batch["inc_mask"]] if "inc_ids" in batch else []
        with use_mesh(self.mesh):
            enc, att_mask = self.model.encode_for_decode(batch["images"], batch["pids"],
                                                         batch["valid"], e, *inc)
        st = self.model.init_decode_state(enc, e, 1)
        return {"cross_k": st["cross_k"], "cross_v": st["cross_v"], "att_mask": att_mask}

    @torch.inference_mode()
    def _ensure_loop(self, pack) -> None:
        """The engine, built (and on the card captured) at the first pack."""
        if self.loop is not None:
            return
        n = self.slots * self.k
        p_len = pack["att_mask"].shape[1]
        cross = pack["cross_k"][0]
        # the encoder's width (the cross K / V hold D / mp under split heads)
        zeros_enc = cross.new_zeros((self.slots, p_len, self.model.d_model))
        dec0 = self.model.init_decode_state(zeros_enc, n, self.max_len)
        if self.ancestor_kv:
            # lineage table over ring slots: anc[s, j, t'] = the physical beam row
            # holding beam j's ancestor K/V at slot t'; entries outside a slot's
            # age window are masked, so admission never clears it
            dec0["anc"] = torch.zeros(self.slots, self.k, self.max_len, dtype=torch.int32,
                                      device=self.device)
        att_mask0 = torch.ones(self.slots, p_len, dtype=pack["att_mask"].dtype,
                               device=self.device)
        self.loop = ContinuousLoop(self._step, dec0, att_mask0, **self._loop_kw)

    def serve(self, loader, prefetch: int = 2, depth: int = 4):
        """A report per study of ``loader`` (eval-loader batches with host
        extras '_image_ids'[, '_gts', '_aux']). Returns (records, stats) and
        keeps the stats in ``self.stats``. Each call starts from a fresh carry
        (ring position 0), so its records do not depend on earlier calls.
        ``wall_s`` / ``reports_per_s`` end at the last read, as the JAX engine
        counts them; ``drain_s`` / ``drained_reports_per_s`` also count the
        speculative dispatches the card runs after it (``issued_steps`` steps
        in all, ``segment_steps`` of them read back).

        Up to ``depth`` dispatches stay in flight; each one's (host_meta,
        best_seq) is copied to pinned host memory without blocking and read in
        dispatch order. Pack consumption lives on the device (``pack_pos``),
        so dispatching ahead of the reads stays exact; the host switches packs
        (reset_pos) once a lagged read shows the current one exhausted.
        ``encode_s`` / ``dispatch_s`` / ``wait_s`` are this call's seconds in
        the spans ``continuous.encode`` / ``.dispatch`` / ``.wait``."""
        with span("serve"):
            return self._serve(loader, prefetch, depth)

    def _serve(self, loader, prefetch: int, depth: int):
        from evoke_tpu_torch.data.batching import to_device
        from evoke_tpu_torch.serve import EMPTY_REPORT, staged_batches

        timed = {"encode_s": "continuous.encode", "dispatch_s": "continuous.dispatch",
                 "wait_s": "continuous.wait"}
        before = {key: spans.seconds(name) for key, name in timed.items()}
        captured_before = 0.0 if self.loop is None else self.loop.capture_s
        pending: deque = deque()    # fused packs not yet current
        raw: deque = deque()        # encoded loader batches awaiting fusion
        meta: Dict[int, Dict[str, Any]] = {}
        results: Dict[int, Dict[str, Any]] = {}
        latencies: List[float] = []   # submit (pack encoded) -> harvest read
        service: List[float] = []     # admission dispatch -> harvest read
        admit_t: Dict[int, float] = {}
        next_ticket = n_total = 0
        loader_done = False
        steps = n_packs = 0
        mesh = self.mesh
        batches = staged_batches(loader, self.device, prefetch, self._max_partners, mesh)
        t0 = time.perf_counter()

        def local(x):
            """This rank's rows of a host extra (the whole of it on one device)."""
            return x if mesh is None or x is None else x[mesh.rows(len(x))]

        def pull_pack():
            """-> (pack, n_valid, host tickets) or None when the loader is done."""
            nonlocal next_ticket, n_total, loader_done
            try:
                dev, host = next(batches)
            except StopIteration:
                loader_done = True
                return None
            batch = host["_batch"]
            e_all = len(host["_image_ids"])
            ids = local(host["_image_ids"])
            gts = local(host.get("_gts"))
            e = len(ids)
            # a record's place in loader order: (batch, row of the global batch)
            row0 = 0 if mesh is None else mesh.rows(e_all).start
            order = [(batch, row0 + j) for j in range(e)]
            valid = local(np.asarray(host["_valid"])[:e_all])
            # padded anchors must form a suffix for FIFO prefix admission
            n_valid = int(valid.sum())
            if not valid[:n_valid].all():
                raise ValueError("padded anchors must trail the batch")
            with span("continuous.encode", batch=batch):
                pack = self.encode_pack(dev)
            start = next_ticket
            tickets = np.arange(start, start + e, dtype=np.int32)
            t_submit = time.perf_counter()
            for j in range(n_valid):
                meta[start + j] = {"id": ids[j], "_t_submit": t_submit, "_order": order[j],
                                   **({"gt": gts[j]} if gts is not None else {})}
            aux = local(host.get("_aux"))
            # pinned, non-blocking copies: a pageable one would wait for the
            # dispatches queued on the stream
            with span("serve.stage", batch=batch):
                pack.update(to_device({"ticket": tickets, "aux": (
                    np.zeros(e, np.int32) if aux is None else np.asarray(aux, np.int32))},
                    self.device)[0])
            next_ticket += e
            n_total += n_valid
            return pack, n_valid, tickets[:n_valid]

        g = self.pack_batches

        def make_fused():
            """Up to ``g`` raw packs -> (one [g*E]-row pack, available rows,
            their tickets). Valid rows (each raw pack's prefix) are gathered to
            the front; a short group at the loader's end is padded by
            repeating its first pack, so the pack width stays g*E."""
            nonlocal n_packs
            with span("continuous.fuse", pack=n_packs):
                n_packs += 1
                take = [raw.popleft() for _ in range(min(g, len(raw)))]
                if g == 1:
                    return take[0]
                e = take[0][0]["att_mask"].shape[0]
                if not all(p["att_mask"].shape[0] == e for p, _, _ in take):
                    raise ValueError("ContinuousServer.serve: every loader batch must have the "
                                     "same padded row count (pad every batch to n_anchor), got "
                                     f"{[p['att_mask'].shape[0] for p, _, _ in take]}")
                packs = [p for p, _, _ in take] + [take[0][0]] * (g - len(take))
                front = np.concatenate([np.arange(i * e, i * e + nv)
                                        for i, (_, nv, _) in enumerate(take)])
                perm = np.zeros(g * e, np.int64)
                perm[:len(front)] = front
                perm = to_device({"perm": perm}, self.device)[0]["perm"]
                fused = {key: _tree_map(lambda *xs: torch.cat(xs, 0).index_select(0, perm),
                                        *[p[key] for p in packs]) for key in packs[0]}
                return fused, len(front), np.concatenate([tk for _, _, tk in take])

        def refill_pending():
            while not loader_done and len(raw) < g * max(prefetch, 1):
                got = pull_pack()
                if got is not None:
                    raw.append(got)
            while raw and len(pending) < max(prefetch, 1):
                if not loader_done and len(raw) < g:
                    break   # wait for a full group; the tail pads instead
                pending.append(make_fused())

        with torch.inference_mode():
            refill_pending()
            if not pending:
                self.stats = {"reports": 0.0, "wall_s": 0.0, "reports_per_s": float("nan"),
                              "segment_steps": 0.0, "capture_s": 0.0}
                return [], dict(self.stats)
            cur_pack, cur_avail, cur_tickets = pending.popleft()
            self._ensure_loop(cur_pack)
            loop = self.loop
            loop.init_carry()    # a serve's records do not depend on what ran before it
            cur_reset, cur_id, n_disp = True, 0, 0
            with span("continuous.load_pack", pack=cur_id):
                loop.load_pack(cur_pack)
            reads = _HostReads(loop, depth)
            # (read slot, pack id, avail, tickets, dispatch time, dispatch number)
            inflight: deque = deque()
            # under a mesh a rank whose studies are all done goes on until the
            # loader is: every rank must pull (and gather) every batch
            while len(results) < n_total or (mesh is not None and not loader_done):
                while len(inflight) < depth:
                    with span("continuous.dispatch", dispatch=n_disp):
                        loop.dispatch(cur_avail, cur_reset)
                        slot = reads.issue()
                    cur_reset = False
                    inflight.append((slot, cur_id, cur_avail, cur_tickets, time.perf_counter(),
                                     n_disp))
                    n_disp += 1
                slot, pack_id, avail, tickets, t_dispatched, d = inflight.popleft()
                with span("continuous.wait", dispatch=d):
                    metas, bests = reads.wait(slot)   # [R, B+1, 2], [R, B, L]
                # only consumed dispatches count: the speculative ones still in
                # flight at the end would inflate the steps per study
                steps += self.seg_steps * self.dispatch_segs
                with span("continuous.harvest", dispatch=d):
                    t_now = time.perf_counter()
                    for meta_h, best in zip(metas, bests):
                        # harvests first: a study harvested in this segment was
                        # admitted in an earlier one (harvest -> admit -> decode)
                        for s in np.nonzero(meta_h[:-1, 0])[0]:
                            t = int(meta_h[s, 1])
                            if t in meta and t not in results:   # a padded row has no meta
                                t_submit = meta[t].pop("_t_submit")
                                latencies.append(t_now - t_submit)
                                if t in admit_t:
                                    t_admit = admit_t.pop(t)
                                    service.append(t_now - t_admit)
                                    spans.record("study.queued", t_submit, t_admit, ticket=t)
                                    spans.record("study.decoding", t_admit, t_now, ticket=t)
                                results[t] = {**meta[t], "tokens": best[s].copy()}
                        # admissions: rows [pos - n_adm, pos) of this dispatch's
                        # pack, stamped with the dispatch's time
                        n_adm, pos = int(meta_h[-1, 0]), int(meta_h[-1, 1])
                        for t in tickets[pos - n_adm:pos]:
                            admit_t[int(t)] = t_dispatched
                pack_pos = int(metas[-1][-1, 1])
                if pack_id == cur_id and pack_pos >= avail:
                    refill_pending()
                    if pending:
                        cur_pack, cur_avail, cur_tickets = pending.popleft()
                        cur_id += 1
                        with span("continuous.load_pack", pack=cur_id):
                            loop.load_pack(cur_pack)
                        cur_reset = True
                    elif cur_avail:
                        cur_avail = 0   # drain: keep the pack, admit nothing
                refill_pending()

        wall = time.perf_counter() - t0
        # up to depth - 1 speculative dispatches are still queued at the last
        # read: wait for them, so the drain is timed and serve() leaves nothing
        # of its own on the stream
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        drain = time.perf_counter() - t0 - wall
        records: List[Dict[str, Any]] = []
        with span("serve.records", studies=len(results)):
            for t in sorted(results):
                rec = results[t]
                text = self.tokenizer.decode([int(x) for x in rec.pop("tokens")])
                rec["report"] = text if text.strip() else EMPTY_REPORT
                records.append(rec)
        if mesh is not None:
            # every rank's records, in loader order; the slowest rank's times
            from evoke_tpu_torch.parallel.collectives import gather_objects

            # the mp ranks of a dp group hold the same records: one of them counts
            parts = gather_objects((records, wall, drain), mesh)[::mesh.mp]
            records = sorted((r for recs, _, _ in parts for r in recs),
                             key=lambda r: r["_order"])
            wall = max(w for _, w, _ in parts)
            drain = max(d for _, _, d in parts)
        for rec in records:
            rec.pop("_order")
        drained = wall + drain
        stats = {"reports": float(len(records)), "wall_s": wall,
                 "reports_per_s": len(records) / wall if wall > 0 else float("nan"),
                 "drain_s": drain,
                 "drained_reports_per_s": len(records) / drained if drained > 0 else float("nan"),
                 "segment_steps": float(steps), "issued_steps": float(loop.steps_run),
                 **{key: spans.seconds(name) - before[key] for key, name in timed.items()},
                 "capture_s": loop.capture_s - captured_before, "captured": self.captured}
        if latencies:
            lat = np.asarray(latencies)
            stats["study_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
            stats["study_p90_ms"] = float(np.percentile(lat, 90) * 1e3)
        if service:
            srv = np.asarray(service)
            stats["service_p50_ms"] = float(np.percentile(srv, 50) * 1e3)
            stats["service_p90_ms"] = float(np.percentile(srv, 90) * 1e3)
        self.stats = stats
        return records, dict(stats)
