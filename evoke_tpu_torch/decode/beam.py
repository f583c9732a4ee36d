"""Batched beam search over a KV-cached step (port of evoke_tpu/decode/beam.py).

Contracts kept from the JAX package: a beam that emits EOS (or reaches
max_len) is recorded with its length-penalised score and knocked down by 1000;
the best recorded beams are the output; every top-k breaks ties to the lowest
index. The loop is a Python loop; with ``early_stop`` it reads one flag on
the host per step (``all(ever_finished)``) to leave once every beam finished.
Diverse beam search, greedy and sampled decoding are ROADMAP A12;
``chain_split`` has no counterpart.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index as topk

NEG_INF = -1e9

StepFn = Callable


def penalty_fn(spec: str) -> Callable:
    """'' -> identity; 'wu_a' -> score / (((5+len)/6)**a); 'avg_a' -> score / len**a."""
    if not spec:
        return lambda length, score: score
    name, _, alpha = spec.partition("_")
    a = float(alpha) if alpha else 0.0
    if name == "wu":
        return lambda length, score: score / (((5.0 + length) / 6.0) ** a)
    if name == "avg":
        return lambda length, score: score / torch.clamp_min(length, 1.0) ** a
    raise ValueError(f"unknown length penalty {spec!r}")


class BeamResult(NamedTuple):
    seqs: torch.Tensor        # [B, beam, L] best-first
    scores: torch.Tensor      # [B, beam]
    alive_logp: torch.Tensor  # [B, beam]


def _tree_map(fn, x):
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _gather_beams(state, beam_idx, batch: int, beam: int, pos: Optional[int] = None):
    """Reindex the leading N = B*beam axis of every state tensor by beam_idx.

    'cross*' entries stay beam-invariant. With an ``anc`` table (ancestor
    mode) the 'cache_*' entries stay un-permuted too and the lineage advances
    instead: new beam b of sample s descends from physical row beam_idx[s, b],
    so its history is that row's and its slot-``pos`` entry IS that row."""
    flat_idx = (beam_idx + torch.arange(batch, device=beam_idx.device)[:, None] * beam
                ).reshape(-1)

    def gather(x):
        if x.dim() >= 1 and x.shape[0] == batch * beam:
            return x.index_select(0, flat_idx)
        return x

    ancestor = "anc" in state
    out = {}
    for key, v in state.items():
        if key.startswith("cross") or (ancestor and key.startswith("cache_")):
            out[key] = v
        elif key == "anc":
            a = v.gather(1, beam_idx[:, :, None].expand(-1, -1, v.shape[2]))
            a[:, :, pos] = beam_idx.to(a.dtype)
            out[key] = a
        else:
            out[key] = _tree_map(gather, v)
    return out


def _validate_schedule(schedule: Tuple[int, ...], max_len: int) -> Tuple[int, ...]:
    schedule = tuple(schedule)
    if not (schedule and schedule[-1] == max_len
            and all(a < b for a, b in zip(schedule, schedule[1:]))):
        raise ValueError(f"cache_schedule {schedule} must strictly ascend and end at "
                         f"max_len={max_len}")
    return schedule


def grow_caches(state, new_len: int):
    """Zero-pad the time axis of the self-attention caches (axis 1) and of the
    ancestor table (axis 2) to new_len; slots beyond the position are never
    read, so padding mid-decode is exact."""
    if not isinstance(state, dict) or not {"cache_k", "cache_v"} <= set(state):
        raise TypeError("grow_caches: a multi-phase cache_schedule needs a dict decode "
                        "state with 'cache_k'/'cache_v' [N, L, D] caches")

    def pad(x, axis):
        extra = new_len - x.shape[axis]
        if extra <= 0:
            return x
        shape = list(x.shape)
        shape[axis] = extra
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    out = {k: (_tree_map(lambda x: pad(x, 1), v) if k in ("cache_k", "cache_v") else v)
           for k, v in state.items()}
    if "anc" in out:
        out["anc"] = pad(out["anc"], 2)
    return out


@torch.inference_mode()
def beam_search(step: StepFn, state0, batch: int, *, bos_id: int, eos_id: int,
                pad_id: int, vocab_size: int, beam_size: int = 3, max_len: int = 100,
                length_penalty: str = "", suppress_ids: Tuple[int, ...] = (),
                decoding_constraint: bool = False, early_stop: bool = True,
                raw_logits: bool = False, cache_schedule: Optional[Tuple[int, ...]] = None,
                ancestor_kv: bool = False, fused_topk: bool = False) -> BeamResult:
    """Batched beam search over ``step(tok [N], t, state) -> (out, state)``.

    ``state0`` is sized for N = batch * beam_size rows and, with a
    cache_schedule, caches of length schedule[0]. ``out`` is log-probs [N, V];
    with ``raw_logits`` unnormalised logits [N, V] (two-stage exact top-k);
    with ``fused_topk`` the triple (vals [N, k], idx [N, k], lse [N]) of the
    fused vocab tail, suppression applied inside the step."""
    k = beam_size
    n = batch * k
    if fused_topk:
        if not raw_logits:
            raise ValueError("fused_topk requires the raw_logits contract")
        if suppress_ids or decoding_constraint:
            raise ValueError("fused_topk steps suppress inside the kernel; pass "
                             "suppress_ids=() and decoding_constraint=False")
    lp = penalty_fn(length_penalty)
    schedule = (_validate_schedule(cache_schedule, max_len)
                if cache_schedule is not None else (max_len,))
    dev = state0["cache_k"][0].device
    if ancestor_kv:
        lcache = state0["cache_k"][0].shape[1]
        state0 = dict(state0, anc=torch.zeros(batch, k, lcache, dtype=torch.int32,
                                              device=dev))
    later_beams = torch.arange(k, device=dev)[None, :, None] > 0

    tok = torch.full((n,), bos_id, dtype=torch.long, device=dev)
    dec_state = state0
    alive_logp = torch.zeros(batch, k, device=dev)
    seq = torch.full((batch, k, max_len), pad_id, dtype=torch.long, device=dev)
    done_seq = seq.clone()
    done_score = torch.full((batch, k), NEG_INF, device=dev)
    ever_finished = torch.zeros(batch, k, dtype=torch.bool, device=dev)

    def stage2(vals, tok_cand, lse, t):
        logp_cand = vals.float() - lse[:, None]
        cand = (alive_logp.reshape(n)[:, None] + logp_cand).reshape(batch, k, k)
        if t == 0:  # all beams are BOS copies: keep only beam 0's candidates
            cand = torch.where(later_beams, NEG_INF, cand)
        scores, flat_idx = topk(cand.reshape(batch, k * k), k)
        tok_idx = tok_cand.reshape(batch, k * k).long().gather(1, flat_idx)
        return scores, flat_idx // k, tok_idx

    t = 0
    for seg_i, seg_end in enumerate(schedule):
        while t < seg_end and not (early_stop and bool(ever_finished.all())):
            if fused_topk:
                (vals, tok_cand, lse), dec_state = step(tok, t, dec_state)
                scores, beam_idx, tok_idx = stage2(vals, tok_cand, lse, t)
            elif raw_logits:
                logits, dec_state = step(tok, t, dec_state)
                lse = torch.logsumexp(logits.float(), dim=-1)
                for sid in suppress_ids:
                    logits[:, sid] += -1000.0
                if decoding_constraint:
                    logits = torch.where(F.one_hot(tok, vocab_size).bool(), NEG_INF, logits)
                vals, tok_cand = topk(logits, k)
                scores, beam_idx, tok_idx = stage2(vals, tok_cand, lse, t)
            else:
                logp, dec_state = step(tok, t, dec_state)
                for sid in suppress_ids:
                    logp[:, sid] += -1000.0
                if decoding_constraint:
                    logp = torch.where(F.one_hot(tok, vocab_size).bool(), NEG_INF, logp)
                cand = alive_logp[:, :, None] + logp.reshape(batch, k, vocab_size)
                if t == 0:
                    cand = torch.where(later_beams, NEG_INF, cand)
                scores, idx = topk(cand.reshape(batch, k * vocab_size), k)
                beam_idx, tok_idx = idx // vocab_size, idx % vocab_size

            seq = seq.gather(1, beam_idx[:, :, None].expand(-1, -1, max_len))
            seq[:, :, t] = tok_idx
            dec_state = _gather_beams(dec_state, beam_idx, batch, k, pos=t)

            finished = (tok_idx == eos_id) | (t == max_len - 1)
            length = torch.tensor(float(t + 1), device=dev)
            fin_score = torch.where(finished, lp(length, scores), NEG_INF)
            all_scores = torch.cat([done_score, fin_score], dim=1)
            all_seqs = torch.cat([done_seq, seq], dim=1)
            done_score, top_idx = topk(all_scores, k)
            done_seq = all_seqs.gather(1, top_idx[:, :, None].expand(-1, -1, max_len))
            alive_logp = scores - 1000.0 * finished.float()
            ever_finished = ever_finished.gather(1, beam_idx) | finished
            tok = tok_idx.reshape(n)
            t += 1
        if seg_i + 1 < len(schedule):
            dec_state = grow_caches(dec_state, schedule[seg_i + 1])

    pos = torch.arange(max_len, device=dev)[None, None, :]
    is_eos = done_seq == eos_id
    first_eos = torch.where(is_eos.any(-1), is_eos.int().argmax(-1),
                            torch.full_like(done_seq[..., 0], max_len))
    done_seq = torch.where(pos > first_eos[:, :, None], pad_id, done_seq)
    return BeamResult(done_seq, done_score, alive_logp)
