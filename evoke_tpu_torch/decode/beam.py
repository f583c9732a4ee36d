"""Batched beam search over a KV-cached step (port of evoke_tpu/decode/beam.py).

Contracts kept from the JAX package: a beam that emits EOS (or reaches
max_len) is recorded with its length-penalised score and knocked down by 1000;
the best recorded beams are the output; every top-k breaks ties to the lowest
index.

The JAX package runs the whole search as one device program. Here the loop is
``BeamLoop``: one step, ``one_step(t)``, is a function of buffers allocated
once (the carry, the decode state, one set of caches per cache phase), and
every update writes into them in place, so no tensor's address changes
between steps and the host makes no tensor per step. On a CUDA device each
position's step is captured into a CUDA graph (one private memory pool for
all) and the host only replays them; on the CPU the same ``one_step`` runs
eagerly. With ``early_stop`` a device flag (every beam has finished) masks a
surplus step's writes to what the search returns, and the host reads that
flag once per cache phase, never after the last one. Diverse beam search,
greedy and sampled decoding are ROADMAP A12a; ``chain_split`` has no
counterpart.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index as topk
from evoke_tpu_torch.ops.lineage_attention import lineage_attention

NEG_INF = -1e9

StepFn = Callable


def penalty_fn(spec: str) -> Callable:
    """'' -> identity; 'wu_a' -> score / (((5+len)/6)**a); 'avg_a' -> score / len**a.
    ``length`` is a Python number or a tensor."""
    if not spec:
        return lambda length, score: score
    name, _, alpha = spec.partition("_")
    a = float(alpha) if alpha else 0.0
    if name == "wu":
        return lambda length, score: score / (((5.0 + length) / 6.0) ** a)
    if name == "avg":
        def avg(length, score):
            floor = (length.clamp_min(1.0) if isinstance(length, torch.Tensor)
                     else max(length, 1.0))
            return score / floor ** a

        return avg
    raise ValueError(f"unknown length penalty {spec!r}")


class BeamResult(NamedTuple):
    seqs: torch.Tensor        # [B, beam, L] best-first
    scores: torch.Tensor      # [B, beam]
    alive_logp: torch.Tensor  # [B, beam]


def _tree_map(fn, *xs):
    if isinstance(xs[0], (tuple, list)):
        return type(xs[0])(_tree_map(fn, *vs) for vs in zip(*xs))
    return fn(*xs)


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _validate_schedule(schedule: Tuple[int, ...], max_len: int) -> Tuple[int, ...]:
    schedule = tuple(schedule)
    if not (schedule and schedule[-1] == max_len
            and all(a < b for a, b in zip(schedule, schedule[1:]))):
        raise ValueError(f"cache_schedule {schedule} must strictly ascend and end at "
                         f"max_len={max_len}")
    return schedule


class LaunchLedger:
    """How many launches of each hand-written kernel each captured graph holds.

    A wrapper counts a launch on the host when it is called; a replayed graph
    calls no wrapper. ``record`` runs a capture, notes what each wrapper
    counted meanwhile and takes it back off (a capture launches nothing);
    ``replayed`` adds a graph's launches to the wrappers' counts, so a count
    goes on meaning launches on the device."""

    def __init__(self, wrappers: Sequence):
        self.wrappers = tuple(wrappers)
        self.per_graph: Dict[object, Tuple[int, ...]] = {}

    def record(self, key, capture: Callable[[], None]) -> None:
        before = [w.launches for w in self.wrappers]
        try:
            capture()
            self.per_graph[key] = tuple(w.launches - b for w, b in zip(self.wrappers, before))
        finally:
            for w, b in zip(self.wrappers, before):
                w.launches = b

    def replayed(self, key) -> None:
        for w, n in zip(self.wrappers, self.per_graph[key]):
            w.launches += n


class BeamLoop:
    """Beam search over ``step(tok [N], t, state) -> (out, state)`` with every
    buffer allocated once; ``load`` a batch's initial state, then ``run``.

    ``state0`` (a dict with per-layer 'cache_k' / 'cache_v' [N, L, D] caches of
    length schedule[0], beam-invariant 'cross*' entries, and row state such as
    'memory') gives the shapes; N = batch * beam_size. ``out`` is log-probs
    [N, V]; with ``raw_logits`` unnormalised logits [N, V] (two-stage exact
    top-k); with ``fused_topk`` the triple (vals [N, k], idx [N, k], lse [N])
    of the fused vocab tail, suppression applied inside the step. ``step`` may
    write the caches it is given in place or return new ones.

    Cache phases: phase i keeps its own caches (and ancestor table) of length
    schedule[i]; the first step of a phase copies the previous phase's slots
    in (slots beyond the position are never read, so this is exact).

    ``graphs`` (default: on a CUDA device): every position's step is captured
    into a CUDA graph at construction, after one eager step per cache phase,
    and ``run`` replays them. A capture or replay error is raised, never
    retried eagerly. ``graphs=False`` runs ``one_step`` eagerly (the CPU's
    path). After ``load``, ``step`` must find everything else it reads (masks,
    weights) at the addresses it had at construction."""

    @torch.inference_mode()
    def __init__(self, step: StepFn, state0, batch: int, *, bos_id: int, eos_id: int,
                 pad_id: int, vocab_size: int, beam_size: int = 3, max_len: int = 100,
                 length_penalty: str = "", suppress_ids: Tuple[int, ...] = (),
                 decoding_constraint: bool = False, early_stop: bool = True,
                 raw_logits: bool = False,
                 cache_schedule: Optional[Tuple[int, ...]] = None,
                 ancestor_kv: bool = False, fused_topk: bool = False,
                 graphs: Optional[bool] = None):
        if fused_topk:
            if not raw_logits:
                raise ValueError("fused_topk requires the raw_logits contract")
            if suppress_ids or decoding_constraint:
                raise ValueError("fused_topk steps suppress inside the kernel; pass "
                                 "suppress_ids=() and decoding_constraint=False")
        if not isinstance(state0, dict) or not {"cache_k", "cache_v"} <= set(state0):
            raise TypeError("BeamLoop needs a dict decode state with 'cache_k' / 'cache_v' "
                            "[N, L, D] caches")
        self.step, self.batch, self.k, self.n = step, batch, beam_size, batch * beam_size
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size, self.max_len = vocab_size, max_len
        self.lp = penalty_fn(length_penalty)
        self.suppress_ids, self.decoding_constraint = tuple(suppress_ids), decoding_constraint
        self.early_stop, self.raw_logits, self.fused_topk = early_stop, raw_logits, fused_topk
        self.schedule = (_validate_schedule(cache_schedule, max_len)
                         if cache_schedule is not None else (max_len,))
        self._phase_of = [i for i, end in enumerate(self.schedule)
                          for _ in range(end - (self.schedule[i - 1] if i else 0))]
        dev = self.device = _leaves(state0["cache_k"])[0].device
        if any(c.shape[1] != self.schedule[0]
               for c in _leaves(state0["cache_k"]) + _leaves(state0["cache_v"])):
            raise ValueError(f"state0's caches must have length schedule[0] = "
                             f"{self.schedule[0]}")
        self.graphs = dev.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and dev.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, got {dev}")

        k, n = self.k, self.n
        # the carry
        self.tok = torch.empty(n, dtype=torch.long, device=dev)
        self.alive_logp = torch.empty(batch, k, device=dev)
        self.seq = torch.empty(batch, k, max_len, dtype=torch.long, device=dev)
        self.done_seq = torch.empty_like(self.seq)
        self.done_score = torch.empty(batch, k, device=dev)
        self.ever_finished = torch.empty(batch, k, dtype=torch.bool, device=dev)
        # steps taken while some beam was still unfinished (all of them without early_stop)
        self.live_steps = torch.zeros((), dtype=torch.long, device=dev)
        # constants of every step
        self._row0 = (torch.arange(batch, device=dev) * k)[:, None]
        self._later_beams = torch.arange(k, device=dev)[None, :, None] > 0

        # the decode state: one dict per cache phase, sharing all but the caches
        def at_length(length):
            return lambda x: x.new_empty((x.shape[0], length) + tuple(x.shape[2:]))

        shared = {key: _tree_map(torch.empty_like, v) for key, v in state0.items()
                  if key not in ("cache_k", "cache_v")}
        self._phases = []
        for length in self.schedule:
            st = dict(shared, cache_k=_tree_map(at_length(length), state0["cache_k"]),
                      cache_v=_tree_map(at_length(length), state0["cache_v"]))
            if ancestor_kv:
                st["anc"] = torch.empty(batch, k, length, dtype=torch.int32, device=dev)
            self._phases.append(st)
        self.ancestor_kv = ancestor_kv
        self.static_bytes = sum(
            t.numel() * t.element_size() for t in
            [self.tok, self.alive_logp, self.seq, self.done_seq, self.done_score,
             self.ever_finished] + [leaf for v in shared.values() for leaf in _leaves(v)]
            + [leaf for st in self._phases for key in ("cache_k", "cache_v", "anc")
               if key in st for leaf in _leaves(st[key])])

        self.steps_run = 0        # steps queued by the last run()
        self.flag_reads = 0       # host reads of the early-stop flag by the last run()
        self.capture_s = 0.0
        self._loaded = False
        self._graphs: List = []
        self._ledger = LaunchLedger((lineage_attention, fused_logit_topk))
        if self.graphs:
            self.load(state0)     # the eager steps before the capture need a valid carry
            self._capture()
            self._loaded = False

    @torch.inference_mode()
    def load(self, state0) -> None:
        """Copy a batch's initial decode state in and reset the carry."""
        first = self._phases[0]
        for st in self._phases:
            for key in ("cache_k", "cache_v", "anc"):
                for leaf in _leaves(st.get(key, ())):
                    leaf.zero_()
        for key, v in state0.items():
            _tree_map(lambda dst, src: dst.copy_(src), first[key], v)
        self.tok.fill_(self.bos_id)
        self.alive_logp.zero_()
        self.seq.fill_(self.pad_id)
        self.done_seq.fill_(self.pad_id)
        self.done_score.fill_(NEG_INF)
        self.ever_finished.zero_()
        self.live_steps.zero_()
        self._loaded = True

    def _stage2(self, vals, tok_cand, lse, t):
        batch, k = self.batch, self.k
        logp_cand = vals.float() - lse[:, None]
        cand = (self.alive_logp.reshape(self.n)[:, None] + logp_cand).reshape(batch, k, k)
        if t == 0:  # all beams are BOS copies: keep only beam 0's candidates
            cand = torch.where(self._later_beams, NEG_INF, cand)
        scores, flat_idx = topk(cand.reshape(batch, k * k), k)
        tok_idx = tok_cand.reshape(batch, k * k).long().gather(1, flat_idx)
        return scores, flat_idx // k, tok_idx

    def _advance_state(self, st, new_state, beam_idx, t) -> None:
        """Write the step's new decode state into the phase's buffers, rows
        reindexed by ``beam_idx``. 'cross*' entries stay beam-invariant. In
        ancestor mode the caches stay un-permuted too and the lineage advances
        instead: new beam b of sample s descends from physical row
        beam_idx[s, b], so its history is that row's and its slot-``t`` entry
        IS that row."""
        flat_idx = (beam_idx + self._row0).reshape(-1)

        def follow_beams(dst, src):
            rows = src.dim() >= 1 and src.shape[0] == self.n
            return dst.copy_(src.index_select(0, flat_idx) if rows else src)

        def stay(dst, src):   # a step that wrote the buffer itself returns it
            return dst if dst is src else dst.copy_(src)

        for key, buf in st.items():
            if key.startswith("cross"):
                continue
            if key == "anc":
                a = buf.gather(1, beam_idx[:, :, None].expand(-1, -1, buf.shape[2]))
                a[:, :, t] = beam_idx.to(a.dtype)
                buf.copy_(a)
            else:
                unpermuted = self.ancestor_kv and key in ("cache_k", "cache_v")
                _tree_map(stay if unpermuted else follow_beams, buf, new_state[key])

    def one_step(self, t: int) -> None:
        """Position ``t`` of the search, in place on the loop's buffers."""
        batch, k, n, max_len = self.batch, self.k, self.n, self.max_len
        phase = self._phase_of[t]
        st = self._phases[phase]
        if phase and t == self.schedule[phase - 1]:   # the phase's first step: grow
            prev = self._phases[phase - 1]
            for key in ("cache_k", "cache_v"):
                _tree_map(lambda dst, src: dst[:, :src.shape[1]].copy_(src), st[key], prev[key])
            if self.ancestor_kv:
                st["anc"][:, :, :prev["anc"].shape[2]].copy_(prev["anc"])
        if self.early_stop:
            stopped = self.ever_finished.all()

            def keep(old, new):   # a surplus step changes nothing the search returns
                return torch.where(stopped, old, new)

            self.live_steps.add_((~stopped).long())
        else:
            def keep(old, new):
                return new

            self.live_steps.add_(1)

        tok = self.tok
        if self.fused_topk:
            (vals, tok_cand, lse), new_state = self.step(tok, t, st)
            scores, beam_idx, tok_idx = self._stage2(vals, tok_cand, lse, t)
        elif self.raw_logits:
            logits, new_state = self.step(tok, t, st)
            lse = torch.logsumexp(logits.float(), dim=-1)
            for sid in self.suppress_ids:
                logits[:, sid] += -1000.0
            if self.decoding_constraint:
                logits = torch.where(F.one_hot(tok, self.vocab_size).bool(), NEG_INF, logits)
            vals, tok_cand = topk(logits, k)
            scores, beam_idx, tok_idx = self._stage2(vals, tok_cand, lse, t)
        else:
            logp, new_state = self.step(tok, t, st)
            for sid in self.suppress_ids:
                logp[:, sid] += -1000.0
            if self.decoding_constraint:
                logp = torch.where(F.one_hot(tok, self.vocab_size).bool(), NEG_INF, logp)
            cand = self.alive_logp[:, :, None] + logp.reshape(batch, k, self.vocab_size)
            if t == 0:
                cand = torch.where(self._later_beams, NEG_INF, cand)
            scores, idx = topk(cand.reshape(batch, k * self.vocab_size), k)
            beam_idx, tok_idx = idx // self.vocab_size, idx % self.vocab_size

        seq = self.seq.gather(1, beam_idx[:, :, None].expand(-1, -1, max_len))
        seq[:, :, t] = tok_idx
        self.seq.copy_(seq)
        self._advance_state(st, new_state, beam_idx, t)

        finished = (tok_idx == self.eos_id) | (t == max_len - 1)
        fin_score = torch.where(finished, self.lp(float(t + 1), scores), NEG_INF)
        all_scores = torch.cat([self.done_score, fin_score], dim=1)
        all_seqs = torch.cat([self.done_seq, seq], dim=1)
        done_score, top_idx = topk(all_scores, k)
        done_seq = all_seqs.gather(1, top_idx[:, :, None].expand(-1, -1, max_len))
        self.done_score.copy_(keep(self.done_score, done_score))
        self.done_seq.copy_(keep(self.done_seq, done_seq))
        self.alive_logp.copy_(keep(self.alive_logp, scores - 1000.0 * finished.float()))
        self.ever_finished.copy_(self.ever_finished.gather(1, beam_idx) | finished)
        self.tok.copy_(tok_idx.reshape(n))

    def _capture(self) -> None:
        """One eager step per cache phase on a side stream (each kernel's first
        launch at each cache length, the libraries' workspaces and plans), then
        one graph per position, all in one private pool."""
        dev = self.device
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for i in range(len(self.schedule)):
                self.one_step(self.schedule[i - 1] if i else 0)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for t in range(self.max_len):
            graph = torch.cuda.CUDAGraph()

            def capture(graph=graph, t=t):
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    self.one_step(t)

            self._ledger.record(t, capture)
            self._graphs.append(graph)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def all_finished(self) -> bool:
        """The one host read of the loop: has every beam of every sample
        finished? Blocks until the device has run the steps queued so far."""
        self.flag_reads += 1
        return bool(self.ever_finished.all())

    @torch.inference_mode()
    def run(self) -> BeamResult:
        if not self._loaded:
            raise RuntimeError("BeamLoop.run: load() a batch's state first (a loaded "
                               "state is used once)")
        self._loaded = False
        self.flag_reads = 0
        t = 0
        for i, seg_end in enumerate(self.schedule):
            while t < seg_end:
                if self.graphs:
                    self._graphs[t].replay()
                    self._ledger.replayed(t)
                else:
                    self.one_step(t)
                t += 1
            if self.early_stop and i + 1 < len(self.schedule) and self.all_finished():
                break
        self.steps_run = t

        # new tensors, so the result does not alias the loop's buffers
        max_len = self.max_len
        pos = torch.arange(max_len, device=self.device)[None, None, :]
        is_eos = self.done_seq == self.eos_id
        first_eos = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                                torch.full_like(self.done_seq[..., 0], max_len))
        done_seq = torch.where(pos > first_eos[:, :, None], self.pad_id, self.done_seq)
        return BeamResult(done_seq, self.done_score.clone(), self.alive_logp.clone())


def beam_search(step: StepFn, state0, batch: int, **kw) -> BeamResult:
    """One search: build a ``BeamLoop`` (its keywords), load ``state0``, run.
    A caller with many batches of one shape keeps the loop instead."""
    loop = BeamLoop(step, state0, batch, **kw)
    loop.load(state0)
    return loop.run()
