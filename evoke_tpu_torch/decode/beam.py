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
flag once per cache phase, never after the last one. ``chain_split`` has no
counterpart.

The other decoding modes are loops of the same design: ``SampleLoop``
(``greedy_sample``: greedy, temperature, top-k and top-p sampling with the
decoding constraint and trigram blocking, early stop read once per cache
phase), ``DiverseBeamLoop`` (``diverse_beam_search``) and
``DiverseSampleLoop`` (``diverse_sample``), whose groups run staggered over
``max_len + G - 1`` global steps: a group's step is issued only while the
group is active (the host knows when), where JAX computes an inactive
group's step and discards it. Random draws come from a ``torch.Generator``
on the loop's device, reseeded at every ``load`` and registered with every
captured graph, so each replay draws anew; they follow JAX's distribution,
not its draws.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from evoke_tpu_torch.core.profiling import span
from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index as topk
from evoke_tpu_torch.ops.lineage_attention import lineage_attention

NEG_INF = -1e9
# the self-attention caches and their int8 scales: per-phase buffers that grow,
# un-permuted in ancestor mode
CACHE_KEYS = ("cache_k", "cache_v", "cache_k_scale", "cache_v_scale")

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


def advance_state(st, new_state, beam_idx, row0, pos: int, ancestor_kv: bool) -> None:
    """Write a step's new decode state into the buffers ``st``, rows
    reindexed by ``beam_idx`` [B, k] (``row0`` [B, 1]: each sample's first
    row). 'cross*' entries stay beam-invariant. In ancestor mode the caches
    stay un-permuted too and the lineage advances instead: new beam b of
    sample s descends from physical row beam_idx[s, b], so its history is that
    row's and its entry at cache slot ``pos`` (the step position, or the
    physical ring slot of the continuous engine) IS that row."""
    n = beam_idx.numel()
    flat_idx = (beam_idx + row0).reshape(-1)

    def follow_beams(dst, src):
        rows = src.dim() >= 1 and src.shape[0] == n
        return dst.copy_(src.index_select(0, flat_idx) if rows else src)

    def stay(dst, src):   # a step that wrote the buffer itself returns it
        return dst if dst is src else dst.copy_(src)

    for key, buf in st.items():
        if key.startswith("cross"):
            continue
        if key == "anc":
            a = buf.gather(1, beam_idx[:, :, None].expand(-1, -1, buf.shape[2]))
            a[:, :, pos] = beam_idx.to(a.dtype)
            buf.copy_(a)
        else:
            unpermuted = ancestor_kv and key in CACHE_KEYS
            _tree_map(stay if unpermuted else follow_beams, buf, new_state[key])


def write_back(st, new_state) -> None:
    """Write a step's new decode state into the buffers ``st`` row for row
    (no beams to follow); 'cross*' entries stay."""
    for key, buf in st.items():
        if not key.startswith("cross"):
            _tree_map(lambda dst, src: dst if dst is src else dst.copy_(src), buf,
                      new_state[key])


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


def side_stream(device) -> torch.cuda.Stream:
    """A capture stream for ``device`` that starts after everything queued so
    far (the device synchronized first)."""
    torch.cuda.synchronize(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    return side


def capture_graph(ledger: LaunchLedger, key, fn: Callable[[], None], pool,
                  side: torch.cuda.Stream, generators=()) -> torch.cuda.CUDAGraph:
    """``fn`` captured into a new CUDA graph on stream ``side`` in memory pool
    ``pool``; ``ledger`` notes its kernel launches under ``key``. Each of
    ``generators`` is registered with the graph, so a replay draws from the
    generator's current state and advances it."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)

    def capture():
        with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            fn()

    ledger.record(key, capture)
    return graph


def phase_buffers(state0, schedule, anc_shape=None, shared=None) -> List[dict]:
    """The decode-state buffers of a loop: one dict per cache phase, the
    caches (and their int8 scales) at the phase's length, every other entry
    allocated once and shared by the phases; with ``anc_shape`` (B, k) an
    int32 ancestor table [B, k, length] per phase. ``shared`` gives buffers
    to reuse for some entries (a diverse loop's groups share their cross
    K/V)."""
    def at_length(length):
        return lambda x: x.new_empty((x.shape[0], length) + tuple(x.shape[2:]))

    shared = shared or {}
    common = {key: shared[key] if key in shared else _tree_map(torch.empty_like, v)
              for key, v in state0.items() if key not in CACHE_KEYS}
    dev = _leaves(state0["cache_k"])[0].device
    phases = []
    for length in schedule:
        st = dict(common, **{key: _tree_map(at_length(length), state0[key])
                             for key in CACHE_KEYS if key in state0})
        if anc_shape is not None:
            st["anc"] = torch.empty(*anc_shape, length, dtype=torch.int32, device=dev)
        phases.append(st)
    return phases


def load_phases(phases, state0, skip=()) -> None:
    """Zero every phase's caches and ancestor table, then copy ``state0``
    into the first phase (entries in ``skip`` are left as they are)."""
    for st in phases:
        for key in CACHE_KEYS + ("anc",):
            for leaf in _leaves(st.get(key, ())):
                leaf.zero_()
    for key, v in state0.items():
        if key not in skip:
            _tree_map(lambda dst, src: dst.copy_(src), phases[0][key], v)


def enter_phase(phases, schedule, phase_of, t: int) -> dict:
    """The buffers of position ``t``'s cache phase; at a phase's first step
    the previous phase's slots are copied in (slots beyond the position are
    never read, so this is exact)."""
    phase = phase_of[t]
    st = phases[phase]
    if phase and t == schedule[phase - 1]:
        prev = phases[phase - 1]
        for key in CACHE_KEYS:
            if key in st:
                _tree_map(lambda dst, src: dst[:, :src.shape[1]].copy_(src), st[key],
                          prev[key])
        if "anc" in st:
            st["anc"][:, :, :prev["anc"].shape[2]].copy_(prev["anc"])
    return st


def _phase_of(schedule) -> List[int]:
    return [i for i, end in enumerate(schedule)
            for _ in range(end - (schedule[i - 1] if i else 0))]


def _nbytes(carry, *phase_lists) -> int:
    """Bytes of the carry tensors and the decode-state buffers, each buffer
    counted once."""
    seen = {}
    for t in list(carry) + [leaf for phases in phase_lists for st in phases
                            for v in st.values() for leaf in _leaves(v)]:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


class _StaticLoop:
    """What every loop shares: the device its buffers live on, graphs or
    eager, the capture of one CUDA graph per step and the run over them.
    ``one_step(t)`` writes a step into the loop's buffers; ``load`` arms a
    run; ``all_finished`` is the early-stop read."""

    generators = ()     # a sampling loop's generator, registered with every graph

    def _init_loop(self, state0, length: int, graphs) -> None:
        """Check ``state0`` (per-layer 'cache_k' / 'cache_v' [N, L, D] caches
        of length ``length``) and set up the bookkeeping."""
        who = type(self).__name__
        if not isinstance(state0, dict) or not {"cache_k", "cache_v"} <= set(state0):
            raise TypeError(f"{who} needs a dict decode state with 'cache_k' / 'cache_v' "
                            "[N, L, D] caches")
        if any(c.shape[1] != length for key in CACHE_KEYS if key in state0
               for c in _leaves(state0[key])):
            raise ValueError(f"state0's caches must have length schedule[0] = {length}")
        dev = self.device = _leaves(state0["cache_k"])[0].device
        self.graphs = dev.type == "cuda" if graphs is None else bool(graphs)
        if self.graphs and dev.type != "cuda":
            raise ValueError(f"graphs=True needs a CUDA device, got {dev}")
        self.steps_run = 0        # steps queued by the last run()
        self.flag_reads = 0       # host reads of the early-stop flag by the last run()
        self.capture_s = 0.0
        self._loaded = False
        self._graphs: List = []
        self._ledger = LaunchLedger((lineage_attention, fused_logit_topk))

    def _init_generator(self, sample_method: str) -> None:
        """A sampling loop's random stream: a generator on the loop's device
        (None for greedy), reseeded by ``reseed``."""
        self.gen = None if sample_method == "greedy" else torch.Generator(device=self.device)
        self.generators = () if self.gen is None else (self.gen,)

    def reseed(self, seed: int) -> None:
        if self.gen is not None:
            self.gen.manual_seed(int(seed))

    def _capture_steps(self, state0, warm: Sequence[int], n_steps: int) -> None:
        """With ``state0`` loaded, the eager steps ``warm`` on a side stream
        (each kernel's first launch at each cache length, the libraries'
        workspaces and plans), then one CUDA graph per step ``0 ..
        n_steps-1``, all in one private pool, the generators registered."""
        self.load(state0)         # the eager steps before the capture need a valid carry
        dev = self.device
        t0 = time.perf_counter()
        side = side_stream(dev)
        with torch.cuda.stream(side):
            for t in warm:
                self.one_step(t)
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        for t in range(n_steps):
            self._graphs.append(capture_graph(self._ledger, t, lambda t=t: self.one_step(t),
                                              pool, side, self.generators))
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self._loaded = False

    def _run_steps(self, segments, early_stop: bool) -> None:
        """Steps 0 .. segments[-1]-1, replayed or eager; with ``early_stop``
        the host reads ``all_finished()`` at the end of every segment but the
        last and leaves when it holds. A loaded state is used once."""
        if not self._loaded:
            raise RuntimeError(f"{type(self).__name__}.run: load() a batch's state first "
                               "(a loaded state is used once)")
        self._loaded = False
        self.flag_reads = 0
        t = 0
        for i, seg_end in enumerate(segments):
            with span("decode.phase", phase=i, steps=seg_end - t):
                while t < seg_end:
                    if self.graphs:
                        self._graphs[t].replay()
                        self._ledger.replayed(t)
                    else:
                        self.one_step(t)
                    t += 1
            if early_stop and i + 1 < len(segments):
                with span("decode.flag_read", phase=i):
                    finished = self.all_finished()
                if finished:
                    break
        self.steps_run = t


def pad_after_eos(seqs, eos_id: int, pad_id: int):
    """A new tensor: every token after a row's first EOS (along the last
    axis) set to PAD."""
    max_len = seqs.shape[-1]
    pos = torch.arange(max_len, device=seqs.device)
    is_eos = seqs == eos_id
    first_eos = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                            torch.full_like(seqs[..., 0], max_len))
    return torch.where(pos > first_eos[..., None], pad_id, seqs)


class BeamLoop(_StaticLoop):
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
        self.step, self.batch, self.k, self.n = step, batch, beam_size, batch * beam_size
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size, self.max_len = vocab_size, max_len
        self.lp = penalty_fn(length_penalty)
        self.suppress_ids, self.decoding_constraint = tuple(suppress_ids), decoding_constraint
        self.early_stop, self.raw_logits, self.fused_topk = early_stop, raw_logits, fused_topk
        self.schedule = (_validate_schedule(cache_schedule, max_len)
                         if cache_schedule is not None else (max_len,))
        self._phase_of = _phase_of(self.schedule)
        self._init_loop(state0, self.schedule[0], graphs)
        dev = self.device

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
        self._phases = phase_buffers(state0, self.schedule, (batch, k) if ancestor_kv else None)
        self.ancestor_kv = ancestor_kv
        self.static_bytes = _nbytes([self.tok, self.alive_logp, self.seq, self.done_seq,
                                     self.done_score, self.ever_finished], self._phases)
        if self.graphs:
            # one eager step per cache phase, then one graph per position
            self._capture_steps(state0, [self.schedule[i - 1] if i else 0
                                         for i in range(len(self.schedule))], max_len)

    @torch.inference_mode()
    def load(self, state0) -> None:
        """Copy a batch's initial decode state in and reset the carry."""
        load_phases(self._phases, state0)
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

    def one_step(self, t: int) -> None:
        """Position ``t`` of the search, in place on the loop's buffers."""
        batch, k, n, max_len = self.batch, self.k, self.n, self.max_len
        st = enter_phase(self._phases, self.schedule, self._phase_of, t)
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
        advance_state(st, new_state, beam_idx, self._row0, t, self.ancestor_kv)

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

    def all_finished(self) -> bool:
        """The one host read of the loop: has every beam of every sample
        finished? Blocks until the device has run the steps queued so far."""
        self.flag_reads += 1
        return bool(self.ever_finished.all())

    @torch.inference_mode()
    def run(self) -> BeamResult:
        self._run_steps(self.schedule, self.early_stop)
        # new tensors, so the result does not alias the loop's buffers
        done_seq = pad_after_eos(self.done_seq, self.eos_id, self.pad_id)
        return BeamResult(done_seq, self.done_score.clone(), self.alive_logp.clone())


def beam_search(step: StepFn, state0, batch: int, **kw) -> BeamResult:
    """One search: build a ``BeamLoop`` (its keywords), load ``state0``, run.
    A caller with many batches of one shape keeps the loop instead."""
    loop = BeamLoop(step, state0, batch, **kw)
    loop.load(state0)
    return loop.run()


def trigram_penalty(seq, t: int, vocab_size: int, alpha: float = 2.0):
    """[N, V] float32 penalty for step ``t`` of the prefixes ``seq`` [N, L]:
    count * (-0.693 * alpha) for every token w such that (seq[t-2], seq[t-1], w)
    already occurred as a trigram at a position 2 <= i < t (beam.py:510-527)."""
    n, length = seq.shape
    prev_a, prev_b = seq[:, t - 2], seq[:, t - 1]
    idx = torch.arange(length, device=seq.device)
    match = ((torch.roll(seq, 2, dims=1) == prev_a[:, None])
             & (torch.roll(seq, 1, dims=1) == prev_b[:, None])
             & (idx[None, :] >= 2) & (idx[None, :] < t))
    counts = torch.zeros(n, vocab_size, device=seq.device).scatter_add_(1, seq, match.float())
    return counts * (-0.693 * alpha)


def categorical(logits, gen):
    """One draw per row from softmax(``logits``) by the Gumbel-max rule of
    ``jax.random.categorical``: argmax(logits + G), G = -log(-log(u)), u
    uniform in [tiny, 1) from the generator ``gen``."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device).clamp_min(
        torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def filter_logits(logp, sample_method: str, temperature: float, top_k: int, top_p: float):
    """The sampler's logits: ``logp / temperature`` with what top-k or top-p
    drops set to -1e9 (beam.py:542-552). Top-k keeps every value at least the
    k-th largest; top-p keeps every value at least the cutoff, the value where
    the sorted softmax's running sum first reaches ``top_p``; ties at either
    threshold all stay."""
    scaled = logp / temperature
    if sample_method == "top_k" and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    elif sample_method == "top_p" and top_p > 0.0:
        sorted_lp = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lp, dim=-1), dim=-1)
        # past the last column (rounding keeps the sum below top_p) nothing is cut
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True).clamp_max(scaled.shape[-1] - 1)
        scaled = torch.where(scaled < sorted_lp.gather(-1, cutoff_idx), NEG_INF, scaled)
    return scaled


def make_sampler(sample_method: str, temperature: float, top_k: int, top_p: float):
    """``(logp [B, V], gen) -> next token [B]`` (int64): greedy (the first
    maximum, as ``jnp.argmax``), or a draw after ``filter_logits``
    (``_make_sampler``, beam.py:530-555)."""
    if sample_method == "top_k" and top_k <= 0:
        raise ValueError("sample_method='top_k' requires top_k > 0 (it would silently "
                         "degrade to plain sampling)")
    if sample_method == "top_p" and not 0.0 < top_p <= 1.0:
        raise ValueError("sample_method='top_p' requires 0 < top_p <= 1")

    def sample_next(logp, gen):
        if sample_method == "greedy":
            return torch.argmax(logp, dim=-1)
        return categorical(filter_logits(logp, sample_method, temperature, top_k, top_p), gen)

    return sample_next


def _group_penalty(seqs_prev, t_local: int, batch: int, vocab_size: int, device):
    """[B, V] float32: how many rows of the earlier groups chose each token
    at local time ``t_local`` (``seqs_prev``: each group's seq [B, r, L])."""
    pen = torch.zeros(batch, vocab_size, device=device)
    for seq in seqs_prev:
        chosen = seq[:, :, t_local]
        pen.scatter_add_(1, chosen, torch.ones(chosen.shape, device=device))
    return pen


class SampleLoop(_StaticLoop):
    """``greedy_sample`` (beam.py:558-619) as a loop of static buffers: one
    token a row and step, greedy or drawn (``make_sampler``), with the
    decoding constraint (no immediate repeat, from t 1) and trigram blocking
    (from t 3) applied to the log-probs first; a row freezes to PAD after
    EOS. ``step(tok [B], t, state) -> (log-probs [B, V], state)``.

    Cache phases as ``BeamLoop``'s; the host reads the early-stop flag (no
    row unfinished) once per phase, never after the last: a surplus step
    writes PAD and adds 0 to the scores, so the result is JAX's, whose loop
    stops at once. ``load(state0, seed)`` reseeds the generator; ``run`` ->
    (seq [B, L], logp_sum [B])."""

    @torch.inference_mode()
    def __init__(self, step: StepFn, state0, batch: int, *, bos_id: int, eos_id: int,
                 pad_id: int, vocab_size: int, max_len: int = 100,
                 sample_method: str = "greedy", temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, block_trigrams: bool = True,
                 decoding_constraint: bool = False,
                 cache_schedule: Optional[Tuple[int, ...]] = None,
                 graphs: Optional[bool] = None):
        self.step, self.batch = step, batch
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size, self.max_len = vocab_size, max_len
        self.sample_next = make_sampler(sample_method, temperature, top_k, top_p)
        self.block_trigrams, self.decoding_constraint = block_trigrams, decoding_constraint
        self.schedule = (_validate_schedule(cache_schedule, max_len)
                         if cache_schedule is not None else (max_len,))
        self._phase_of = _phase_of(self.schedule)
        self._init_loop(state0, self.schedule[0], graphs)
        self._init_generator(sample_method)
        dev = self.device
        self.tok = torch.empty(batch, dtype=torch.long, device=dev)
        self.unfinished = torch.empty(batch, dtype=torch.bool, device=dev)
        self.seq = torch.empty(batch, max_len, dtype=torch.long, device=dev)
        self.logp_sum = torch.empty(batch, device=dev)
        self._phases = phase_buffers(state0, self.schedule)
        self.static_bytes = _nbytes([self.tok, self.unfinished, self.seq, self.logp_sum],
                                    self._phases)
        if self.graphs:
            self._capture_steps(state0, [self.schedule[i - 1] if i else 0
                                         for i in range(len(self.schedule))], max_len)

    @torch.inference_mode()
    def load(self, state0, seed: int = 0) -> None:
        """Copy a batch's initial decode state in, reset the carry, reseed."""
        load_phases(self._phases, state0)
        self.tok.fill_(self.bos_id)
        self.unfinished.fill_(True)
        self.seq.fill_(self.pad_id)
        self.logp_sum.zero_()
        self.reseed(seed)
        self._loaded = True

    def one_step(self, t: int) -> None:
        st = enter_phase(self._phases, self.schedule, self._phase_of, t)
        logp, new_state = self.step(self.tok, t, st)
        if self.decoding_constraint and t > 0:
            logp = torch.where(F.one_hot(self.tok, self.vocab_size).bool(), NEG_INF, logp)
        if self.block_trigrams and t >= 3:
            logp = logp + trigram_penalty(self.seq, t, self.vocab_size)
        nxt = torch.where(self.unfinished, self.sample_next(logp, self.gen), self.pad_id)
        picked = logp.gather(1, nxt[:, None])[:, 0]
        self.logp_sum.add_(picked * self.unfinished.float())
        self.unfinished.logical_and_(nxt != self.eos_id)
        self.seq[:, t] = nxt
        write_back(st, new_state)
        self.tok.copy_(nxt)

    def all_finished(self) -> bool:
        """The loop's one host read a phase: has every row emitted EOS?"""
        self.flag_reads += 1
        return not bool(self.unfinished.any())

    @torch.inference_mode()
    def run(self):
        self._run_steps(self.schedule, early_stop=True)
        return self.seq.clone(), self.logp_sum.clone()


class _GroupLoop(_StaticLoop):
    """What the diverse loops share: ``groups`` decode states (one cache
    phase of ``max_len`` each, their cross K/V one set of buffers), the
    staggered schedule of ``max_len + G - 1`` global steps, and capture.
    Group g is active at global step t iff g <= t <= max_len + g - 1, at
    local time t - g."""

    def _init_groups(self, state0, groups: int, anc_shape, graphs) -> None:
        self._init_loop(state0, self.max_len, graphs)
        self.groups = groups
        self.n_steps = self.max_len + groups - 1
        first = phase_buffers(state0, (self.max_len,), anc_shape)
        cross = {key: v for key, v in first[0].items() if key.startswith("cross")}
        self._states = [first[0]] + [phase_buffers(state0, (self.max_len,), anc_shape,
                                                   shared=cross)[0]
                                     for _ in range(groups - 1)]
        self._cross = tuple(cross)

    def _active(self, t: int):
        """(group, local time) of every group active at global step ``t``."""
        return [(g, t - g) for g in range(self.groups) if g <= t <= self.max_len + g - 1]

    def _load_states(self, state0) -> None:
        for g, st in enumerate(self._states):
            load_phases([st], state0, skip=self._cross if g else ())

    def _capture_groups(self, state0) -> None:
        # every group is active at global step G - 1
        self._capture_steps(state0, [self.groups - 1], self.n_steps)

    def _run(self) -> None:
        self._run_steps((self.n_steps,), early_stop=False)


class DiverseBeamLoop(_GroupLoop):
    """``diverse_beam_search`` (beam.py:404-507): ``group_size`` groups of
    bdash = beam_size / group_size beams, staggered; at local time t group g's
    log-probs lose ``diversity_lambda`` for every beam of a group < g that
    chose the token at the same local time (those groups have already taken
    this global step), then a beam step of width bdash. The done beams of all
    groups are merged best-first at the end. ``state0`` is one group's
    decode state (batch * bdash rows, caches of ``max_len``); with
    ``ancestor_kv`` and bdash > 1 each group keeps an ancestor table and
    un-permuted caches. ``step`` returns log-probs [N, V]."""

    @torch.inference_mode()
    def __init__(self, step: StepFn, state0, batch: int, *, bos_id: int, eos_id: int,
                 pad_id: int, vocab_size: int, beam_size: int, group_size: int,
                 max_len: int = 100, diversity_lambda: float = 0.5,
                 length_penalty: str = "", ancestor_kv: bool = False,
                 graphs: Optional[bool] = None):
        g = group_size
        bdash = beam_size // g
        if bdash * g != beam_size:
            raise ValueError(f"beam_size {beam_size} must divide by group_size {g}")
        self.step, self.batch, self.k, self.n = step, batch, bdash, batch * bdash
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size, self.max_len = vocab_size, max_len
        self.lam, self.lp = diversity_lambda, penalty_fn(length_penalty)
        self.ancestor_kv = ancestor_kv and bdash > 1
        self._init_groups(state0, g, (batch, bdash) if self.ancestor_kv else None, graphs)
        dev = self.device
        self._carry = [dict(tok=torch.empty(self.n, dtype=torch.long, device=dev),
                            alive=torch.empty(batch, bdash, device=dev),
                            seq=torch.empty(batch, bdash, max_len, dtype=torch.long,
                                            device=dev),
                            done_seq=torch.empty(batch, bdash, max_len, dtype=torch.long,
                                                 device=dev),
                            done_score=torch.empty(batch, bdash, device=dev))
                       for _ in range(g)]
        self._row0 = (torch.arange(batch, device=dev) * bdash)[:, None]
        self._later_beams = torch.arange(bdash, device=dev)[None, :, None] > 0
        self.static_bytes = _nbytes([v for c in self._carry for v in c.values()],
                                    self._states)
        if self.graphs:
            self._capture_groups(state0)

    @torch.inference_mode()
    def load(self, state0) -> None:
        self._load_states(state0)
        for c in self._carry:
            c["tok"].fill_(self.bos_id)
            c["alive"].zero_()
            c["seq"].fill_(self.pad_id)
            c["done_seq"].fill_(self.pad_id)
            c["done_score"].fill_(NEG_INF)
        self._loaded = True

    def one_step(self, t: int) -> None:
        batch, k, max_len, vocab = self.batch, self.k, self.max_len, self.vocab_size
        for g, tl in self._active(t):
            c, st = self._carry[g], self._states[g]
            logp, new_state = self.step(c["tok"], tl, st)
            logp = logp.reshape(batch, k, vocab)
            if g:
                pen = _group_penalty([self._carry[p]["seq"] for p in range(g)], tl, batch,
                                     vocab, self.device)
                logp = logp - pen[:, None, :] * self.lam
            cand = c["alive"][:, :, None] + logp
            if tl == 0:
                cand = torch.where(self._later_beams, NEG_INF, cand)
            scores, idx = topk(cand.reshape(batch, k * vocab), k)
            beam_idx, tok_idx = idx // vocab, idx % vocab
            seq = c["seq"].gather(1, beam_idx[:, :, None].expand(-1, -1, max_len))
            seq[:, :, tl] = tok_idx
            c["seq"].copy_(seq)
            advance_state(st, new_state, beam_idx, self._row0, tl, self.ancestor_kv)
            finished = (tok_idx == self.eos_id) | (tl == max_len - 1)
            fin_score = torch.where(finished, self.lp(float(tl + 1), scores), NEG_INF)
            done_score, top = topk(torch.cat([c["done_score"], fin_score], dim=1), k)
            done_seq = torch.cat([c["done_seq"], seq], dim=1).gather(
                1, top[:, :, None].expand(-1, -1, max_len))
            c["done_score"].copy_(done_score)
            c["done_seq"].copy_(done_seq)
            c["alive"].copy_(scores - 1000.0 * finished.float())
            c["tok"].copy_(tok_idx.reshape(self.n))

    @torch.inference_mode()
    def run(self) -> BeamResult:
        self._run()
        seqs = torch.cat([c["done_seq"] for c in self._carry], dim=1)
        scores = torch.cat([c["done_score"] for c in self._carry], dim=1)
        order = torch.sort(-scores, dim=1, stable=True).indices    # jnp.argsort(-scores)
        seqs = seqs.gather(1, order[:, :, None].expand(-1, -1, self.max_len))
        return BeamResult(pad_after_eos(seqs, self.eos_id, self.pad_id), scores.gather(1, order),
                          torch.cat([c["alive"] for c in self._carry], dim=1))


class DiverseSampleLoop(_GroupLoop):
    """``diverse_sample`` (beam.py:622-725) with both of its documented
    departures from the reference: ``group_size`` staggered chains a study;
    at local time t group g's ``log_softmax(logp / temperature)`` loses
    ``diversity_lambda`` at each token an earlier group chose at the same
    local time (each study by its own groups only), then the decoding
    constraint and trigram blocking, then one token (the sampler at
    temperature 1); rows freeze to PAD after EOS. ``state0``: one group's
    decode state (``batch`` rows, caches of ``max_len``). ``run`` -> (seqs
    [B, G, L], logp_sum [B, G])."""

    @torch.inference_mode()
    def __init__(self, step: StepFn, state0, batch: int, *, bos_id: int, eos_id: int,
                 pad_id: int, vocab_size: int, group_size: int, max_len: int = 100,
                 sample_method: str = "greedy", temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, diversity_lambda: float = 0.5,
                 block_trigrams: bool = True, decoding_constraint: bool = False,
                 graphs: Optional[bool] = None):
        self.step, self.batch = step, batch
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        self.vocab_size, self.max_len = vocab_size, max_len
        self.temperature, self.lam = temperature, diversity_lambda
        self.sample_next = make_sampler(sample_method, 1.0, top_k, top_p)
        self.block_trigrams, self.decoding_constraint = block_trigrams, decoding_constraint
        self._init_groups(state0, group_size, None, graphs)
        self._init_generator(sample_method)
        dev = self.device
        self._carry = [dict(tok=torch.empty(batch, dtype=torch.long, device=dev),
                            unfinished=torch.empty(batch, dtype=torch.bool, device=dev),
                            seq=torch.empty(batch, max_len, dtype=torch.long, device=dev),
                            logp_sum=torch.empty(batch, device=dev))
                       for _ in range(group_size)]
        self.static_bytes = _nbytes([v for c in self._carry for v in c.values()],
                                    self._states)
        if self.graphs:
            self._capture_groups(state0)

    @torch.inference_mode()
    def load(self, state0, seed: int = 0) -> None:
        self._load_states(state0)
        for c in self._carry:
            c["tok"].fill_(self.bos_id)
            c["unfinished"].fill_(True)
            c["seq"].fill_(self.pad_id)
            c["logp_sum"].zero_()
        self.reseed(seed)
        self._loaded = True

    def one_step(self, t: int) -> None:
        batch, vocab = self.batch, self.vocab_size
        for g, tl in self._active(t):
            c, st = self._carry[g], self._states[g]
            logp, new_state = self.step(c["tok"], tl, st)
            logp = torch.log_softmax(logp / self.temperature, dim=-1)
            if g:
                pen = _group_penalty([self._carry[p]["seq"][:, None, :] for p in range(g)],
                                     tl, batch, vocab, self.device)
                logp = logp - pen * self.lam
            if self.decoding_constraint and tl > 0:
                logp = torch.where(F.one_hot(c["tok"], vocab).bool(), NEG_INF, logp)
            if self.block_trigrams and tl >= 3:
                logp = logp + trigram_penalty(c["seq"], tl, vocab)
            nxt = torch.where(c["unfinished"], self.sample_next(logp, self.gen), self.pad_id)
            picked = logp.gather(1, nxt[:, None])[:, 0]
            c["logp_sum"].add_(picked * c["unfinished"].float())
            c["unfinished"].logical_and_(nxt != self.eos_id)
            c["seq"][:, tl] = nxt
            write_back(st, new_state)
            c["tok"].copy_(nxt)

    @torch.inference_mode()
    def run(self):
        self._run()
        seqs = torch.stack([c["seq"] for c in self._carry], dim=1)
        return (pad_after_eos(seqs, self.eos_id, self.pad_id),
                torch.stack([c["logp_sum"] for c in self._carry], dim=1))


def greedy_sample(step: StepFn, state0, batch: int, seed: int = 0, **kw):
    """One ``greedy_sample``: build a ``SampleLoop`` (its keywords), load, run."""
    loop = SampleLoop(step, state0, batch, **kw)
    loop.load(state0, seed)
    return loop.run()


def diverse_beam_search(step: StepFn, state0, batch: int, **kw) -> BeamResult:
    """One ``diverse_beam_search`` (``DiverseBeamLoop``'s keywords)."""
    loop = DiverseBeamLoop(step, state0, batch, **kw)
    loop.load(state0)
    return loop.run()


def diverse_sample(step: StepFn, state0, batch: int, seed: int = 0, **kw):
    """One ``diverse_sample`` (``DiverseSampleLoop``'s keywords)."""
    loop = DiverseSampleLoop(step, state0, batch, **kw)
    loop.load(state0, seed)
    return loop.run()
