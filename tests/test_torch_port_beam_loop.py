"""Port parity and structure of the beam loop (decode/beam.BeamLoop), on the CPU.

- ``beam_search`` against the JAX ``beam_search`` on the same R2Gen decoder
  weights (float32, toy dimensions) for the three tail contracts (log-probs,
  raw logits, the fused logit + top-k triple over ancestor caches; the JAX
  side runs its Pallas kernels in interpret mode): identical sequences, scores
  and alive log-probs within 1e-5 (relative and absolute; float32 sums in
  another order).
- Early stop: the decoder's EOS logit bias is switched from -50 to +50 at a
  step of the first or second phase of ``cache_schedule=(3, 5, 7)``, so every
  beam finishes there. The JAX loop leaves at once; the port's runs on to the
  end of the phase. Sequences, scores and alive log-probs must still agree
  under '', 'wu_0.8' and 'avg_1.0': a surplus step changes nothing.
- A table-driven step where a surplus step WOULD re-rank the recorded beams
  under 'avg_1.0' if its writes were not masked.
- The early-stop flag is read at most once per cache phase and never after
  the last; buffer addresses do not change over steps; a loop reused for a
  second batch gives what a fresh loop gives; the launch ledger's bookkeeping.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.decode.beam import beam_search as j_beam
from evoke_tpu.models.rm_decoder import RMDecoder as JDec
from evoke_tpu_torch.decode import beam as tbeam
from evoke_tpu_torch.decode.beam import BeamLoop, LaunchLedger, beam_search as t_beam
from evoke_tpu_torch.models.rm_decoder import RMDecoder as TDec
from evoke_tpu_torch.params import load_flax_variables

from _torch_port_util import to_np

torch.set_num_threads(1)
DIMS = dict(d_model=16, d_ff=32, d_vf=24, num_layers=2, num_heads=2, rm_num_slots=3,
            rm_d_model=16, max_seq_len=7)
VOCAB, B, BEAM, P, MAX_LEN = 30, 2, 3, 4, 7
EOS, SCHEDULE, BOOST = VOCAB, (3, 5, 7), 50.0
IDS = dict(bos_id=VOCAB - 1, eos_id=EOS, pad_id=0, vocab_size=VOCAB + 1, beam_size=BEAM,
           max_len=MAX_LEN)
CONTRACTS = {
    "logp": dict(),
    "raw": dict(raw_logits=True),
    "fused": dict(raw_logits=True, fused_topk=True, ancestor_kv=True),
}


@functools.cache
def _pair():
    rng = np.random.default_rng(1)
    att = rng.normal(size=(B, P, 24)).astype(np.float32)
    mask = np.ones((B, P), np.int32)
    ids = rng.integers(1, VOCAB, size=(B, MAX_LEN)).astype(np.int32)
    jd = JDec(vocab_size=VOCAB, drop_prob_lm=0.0, dtype=jnp.float32, **DIMS)
    v = to_np(jax.jit(jd.init)(jax.random.key(0), att, mask, ids,
                               np.ones((B, MAX_LEN), np.int32)))
    lg = v["params"]["logit"]
    lg["kernel"] = (rng.normal(size=lg["kernel"].shape) * 2).astype(np.float32)
    td = TDec(vocab_size=VOCAB, dtype=torch.float32, **DIMS).eval()
    load_flax_variables(td, v)
    return jd, v, td, att, mask


def _steps(contract, switch_at):
    """(jax step, torch step) of one contract. With ``switch_at`` the EOS
    logit bias is -BOOST before that step and +BOOST from it on: a traced
    ``where`` on the JAX side, an in-place copy into the bias at steps 0 and
    ``switch_at`` on the port's (its ``t`` is a Python number)."""
    jd, v, td, att, mask = _pair()
    bias0 = v["params"]["logit"]["bias"]
    eos_col = np.zeros_like(bias0)
    eos_col[EOS] = 1.0
    kw = (dict(return_topk=BEAM, topk_suppress=(4,)) if contract == "fused"
          else dict(return_logits=contract == "raw"))

    def j_step(tok, pos, st):
        vv = v
        if switch_at is not None:
            bias = bias0 + jnp.where(pos >= switch_at, BOOST, -BOOST) * eos_col
            vv = dict(v, params=dict(v["params"], logit=dict(v["params"]["logit"], bias=bias)))
        return jd.apply(vv, tok, pos, st, mask, method=jd.decode_step, **kw)

    tmask = torch.as_tensor(mask)
    lo, hi = (torch.as_tensor(bias0 + s * BOOST * eos_col) for s in (-1.0, 1.0))

    def t_step(tok, pos, st):
        if switch_at is not None and pos in (0, switch_at):
            td.logit.bias.copy_(hi if pos >= switch_at else lo)
        return td.decode_step(tok, pos, st, tmask, **kw)

    return j_step, t_step


def _states(lmax, att=None):
    jd, v, td, att0, mask = _pair()
    att = att0 if att is None else att
    je = jd.apply(v, att, mask, method=jd.encode)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
    return (jd.apply(v, je, B * BEAM, lmax, method=jd.init_decode_state),
            td.init_decode_state(te, B * BEAM, lmax))


def _restore_bias():
    _, v, td, _, _ = _pair()
    with torch.no_grad():
        td.logit.bias.copy_(torch.tensor(v["params"]["logit"]["bias"]))


def _assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want.seqs), got.seqs.numpy())
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(want.alive_logp), got.alive_logp.numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("contract,kw", [
    ("logp", dict(early_stop=False)),
    ("raw", dict(suppress_ids=(4,), decoding_constraint=True, length_penalty="wu_0.8",
                 cache_schedule=SCHEDULE)),
    ("raw", dict(ancestor_kv=True, early_stop=False, length_penalty="avg_1.0",
                 cache_schedule=(2, 7))),
    ("fused", dict(cache_schedule=SCHEDULE, length_penalty="wu_0.8")),
    ("fused", dict(cache_schedule=(2, 7), early_stop=False)),
])
def test_beam_search_contracts_match_jax(monkeypatch, contract, kw):
    monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
    j_step, t_step = _steps(contract, None)
    kw = dict(IDS, **CONTRACTS[contract], **kw)
    js, ts = _states(kw.get("cache_schedule", (MAX_LEN,))[0])
    want = j_beam(j_step, js, B, **kw)
    got = t_beam(t_step, ts, B, **kw)
    _assert_same(want, got)
    assert len(np.unique(got.seqs.numpy())) > 3


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("penalty", ["", "wu_0.8", "avg_1.0"])
def test_early_stop_surplus_steps_change_nothing(monkeypatch, contract, penalty):
    """Every beam finishes at ``switch_at`` (first phase: step 1; second
    phase: step 3, alternating over the cases). JAX stops there; the port
    runs to the end of that phase and must return the same."""
    monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
    case = sorted(CONTRACTS).index(contract) + ["", "wu_0.8", "avg_1.0"].index(penalty)
    switch_at = (1, 3)[case % 2]
    j_step, t_step = _steps(contract, switch_at)
    kw = dict(IDS, **CONTRACTS[contract], cache_schedule=SCHEDULE, length_penalty=penalty,
              early_stop=True)
    js, ts = _states(SCHEDULE[0])
    want = j_beam(j_step, js, B, **kw)
    try:
        loop = BeamLoop(t_step, ts, B, **kw)
        loop.load(ts)
        got = loop.run()
    finally:
        _restore_bias()
    _assert_same(want, got)
    end_of_phase = (3, 5)[case % 2]
    assert loop.steps_run == end_of_phase                   # surplus steps were run
    assert int(loop.live_steps) == switch_at + 1            # what JAX's loop ran
    assert (got.seqs.numpy() == EOS).any(-1).all()          # every recorded beam ended
    assert not np.isin(got.seqs.numpy()[:, :, switch_at + 1:], [EOS]).any()


# ---- a table-driven step: no model, the scores chosen so that a surplus step matters ----

def _table_loop(schedule, penalty, early_stop=True, table=None):
    """Log-probs: EOS 0, every other token -3000. Step 0 records beam 0 (score
    0) and leaves beams 1, 2 alive at -3000; step 1 finishes all three (the
    knocked-down beam 0 again, at -1000). A further step would record
    knocked-down beams at about -2000 / 3 under 'avg_1.0', above the -1500 the
    buffer holds: the stopped flag must mask it."""
    n, v = 2 * BEAM, 8
    if table is None:
        table = torch.full((n, v), -3000.0)
        table[:, 7] = 0.0

    def step(tok, t, st):
        return table.clone(), st

    zeros = (torch.zeros(n, schedule[0], 1),)
    state0 = dict(cache_k=zeros, cache_v=zeros, memory=torch.zeros(n, 2))
    loop = BeamLoop(step, state0, 2, bos_id=6, eos_id=7, pad_id=0, vocab_size=v,
                    beam_size=BEAM, max_len=schedule[-1], length_penalty=penalty,
                    cache_schedule=schedule, early_stop=early_stop)
    loop.load(state0)
    return loop


@pytest.mark.parametrize("penalty", ["", "wu_0.8", "avg_1.0"])
def test_masked_surplus_step_cannot_rerank(penalty):
    exact = _table_loop((1, 2, 3, 4, 5, 6), penalty)       # a read after every step
    want = exact.run()
    assert exact.steps_run == 2 and int(exact.live_steps) == 2
    loop = _table_loop((4, 6), penalty)                     # two surplus steps
    got = loop.run()
    assert loop.steps_run == 4 and int(loop.live_steps) == 2
    for a, b in zip(want, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    full = _table_loop((6,), penalty, early_stop=False).run()
    if penalty == "avg_1.0":   # the unmasked steps do re-rank: the case is not vacuous
        assert not torch.equal(full.scores, want.scores)


@pytest.mark.parametrize("schedule,finish,reads,steps", [
    ((3, 5, 7), True, 1, 3),      # all finished in phase 1: one read, then out
    ((3, 5, 7), False, 2, 7),     # never finished: one read per phase but the last
    ((7,), True, 0, 7),           # one phase: nothing is read
])
def test_flag_is_read_at_most_once_per_phase(monkeypatch, schedule, finish, reads, steps):
    table = None
    if not finish:                                          # EOS never among the top 3
        table = torch.zeros(2 * BEAM, 8)
        table[:, 7] = -3000.0
    loop = _table_loop(schedule, "", table=table)
    seen = []
    read = BeamLoop.all_finished

    def hooked(self):
        seen.append(self.steps_run)
        return read(self)

    monkeypatch.setattr(BeamLoop, "all_finished", hooked)
    loop.run()
    assert len(seen) == reads == loop.flag_reads and loop.steps_run == steps
    loop = _table_loop(schedule, "", early_stop=False, table=table)
    loop.run()
    assert len(seen) == reads and loop.flag_reads == 0 and loop.steps_run == schedule[-1]


def _buffers(loop):
    out = [loop.tok, loop.alive_logp, loop.seq, loop.done_seq, loop.done_score,
           loop.ever_finished, loop.live_steps]
    for st in loop._phases:
        for v in st.values():
            out += tbeam._leaves(v)
    return out


@pytest.mark.parametrize("contract", sorted(CONTRACTS))
def test_buffer_addresses_do_not_change(contract):
    """What graph capture relies on: a step writes into the loop's buffers and
    replaces none, at a phase boundary too."""
    _, t_step = _steps(contract, None)
    _, ts = _states(SCHEDULE[0])
    loop = BeamLoop(t_step, ts, B, **dict(IDS, **CONTRACTS[contract], cache_schedule=SCHEDULE))
    loop.load(ts)
    before = [(t.data_ptr(), tuple(t.shape)) for t in _buffers(loop)]
    with torch.inference_mode():
        for t in range(5):                                  # crosses into phases 2 and 3
            loop.one_step(t)
    assert before == [(t.data_ptr(), tuple(t.shape)) for t in _buffers(loop)]
    assert loop.static_bytes == sum(t.numel() * t.element_size()
                                    for t in {b.data_ptr(): b for b in _buffers(loop)
                                              if b is not loop.live_steps}.values())


def test_reused_loop_equals_fresh_loop():
    """A second batch through the same loop (buffers reused) == a fresh loop."""
    _, t_step = _steps("fused", None)
    kw = dict(IDS, **CONTRACTS["fused"], cache_schedule=SCHEDULE, length_penalty="wu_0.8")
    _, first = _states(SCHEDULE[0])
    other = np.random.default_rng(7).normal(size=(B, P, 24)).astype(np.float32)
    _, second = _states(SCHEDULE[0], att=other)
    loop = BeamLoop(t_step, first, B, **kw)
    loop.load(first)
    res1 = loop.run()
    loop.load(second)
    res2 = loop.run()
    fresh = t_beam(t_step, second, B, **kw)
    for a, b in zip(res2, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(res1.seqs, res2.seqs)
    assert res1.seqs.data_ptr() != res2.seqs.data_ptr() != loop.done_seq.data_ptr()
    with pytest.raises(RuntimeError, match="load"):
        loop.run()                                          # a loaded state is used once


def test_graphs_need_a_cuda_device():
    _, t_step = _steps("raw", None)
    _, ts = _states(MAX_LEN)
    with pytest.raises(ValueError, match="CUDA"):
        BeamLoop(t_step, ts, B, **dict(IDS, raw_logits=True, graphs=True))
    assert BeamLoop(t_step, ts, B, **dict(IDS, raw_logits=True)).graphs is False


def test_penalty_takes_numbers_and_tensors():
    score = torch.tensor([-3.0, -7.5])
    for spec in ("", "wu_0.8", "avg_1.0", "avg_0.5"):
        lp = tbeam.penalty_fn(spec)
        for length in (0.0, 1.0, 4.0):
            torch.testing.assert_close(lp(length, score), lp(torch.tensor(length), score))
    with pytest.raises(ValueError, match="penalty"):
        tbeam.penalty_fn("nope_1")


def test_launch_ledger_bookkeeping():
    """A capture counts nothing; a replay adds what its graph holds."""
    class Wrapper:
        launches = 0

    k1, k2 = Wrapper(), Wrapper()
    k1.launches, k2.launches = 5, 2                         # launched eagerly before
    ledger = LaunchLedger((k1, k2))

    def captured_step():
        k1.launches += 3
        k2.launches += 1

    ledger.record(0, captured_step)
    ledger.record(1, lambda: None)                          # a graph without either kernel
    assert (k1.launches, k2.launches) == (5, 2)
    assert ledger.per_graph == {0: (3, 1), 1: (0, 0)}
    for key in (0, 0, 1):
        ledger.replayed(key)
    assert (k1.launches, k2.launches) == (11, 4)

    def failing():
        k1.launches += 3
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        ledger.record(2, failing)
    assert k1.launches == 11 and 2 not in ledger.per_graph
