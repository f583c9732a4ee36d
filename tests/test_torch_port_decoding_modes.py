"""Port parity: every decoding mode and the int8 KV cache (decode/beam.py's
SampleLoop, DiverseBeamLoop, DiverseSampleLoop; models/layers.py's quantized
cache; train/steps.py's dispatch), against the JAX package on the CPU at
float32.

Deterministic modes are held on tokens: greedy (trigram blocking on and off,
the decoding constraint, phased caches, early stop), diverse beam search
(beam 4, group 2, reorder and ancestor caches), diverse sampling with the
greedy method, sample_n and int8 beam search: identical tokens; scores
within 1e-5 (float32 sums in another order). ``trigram_penalty`` and
``quantized_cache_update`` equal JAX's (atol 1e-6; the quantized values
exactly, half to even). Sampled modes cannot reproduce ``jax.random`` draws,
so they are held on their distribution: the sampler's kept set equals a
numpy rendering of JAX's top-k / top-p rule (ties at the threshold kept), its
draws pass a chi-square test (p > 1e-3) against the filtered softmax, top-k
1 and a tiny top-p give the argmax, every sampled token lies in its step's
kept set, and a seed gives the same tokens twice and another seed others.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.decode import beam as jbeam
from evoke_tpu.models import layers as jlayers
from evoke_tpu.models.rm_decoder import RMDecoder as JDec
from evoke_tpu.train.steps import TrainState, make_generate_step as j_make
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.decode import beam as tbeam
from evoke_tpu_torch.models import layers as tlayers
from evoke_tpu_torch.models.rm_decoder import RMDecoder as TDec
from evoke_tpu_torch.params import load_flax_variables
from evoke_tpu_torch.train.steps import make_generate_step

from _torch_port_util import Tok, tiny_pair, to_np, torch_batch

torch.set_num_threads(1)
DIMS = dict(d_model=16, d_ff=32, d_vf=24, num_layers=2, num_heads=2, rm_num_slots=3,
            rm_d_model=16, max_seq_len=12)
VOCAB, B, P, L = 30, 2, 4, 12
IDS = dict(bos_id=VOCAB - 1, eos_id=VOCAB, pad_id=0, vocab_size=VOCAB + 1, max_len=L)
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


@functools.cache
def _pair():
    """A toy R2Gen decoder on both sides (sharpened head), its encodings."""
    rng = np.random.default_rng(1)
    att = rng.normal(size=(B, P, 24)).astype(np.float32)
    mask = np.ones((B, P), np.int32)
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    jd = JDec(vocab_size=VOCAB, drop_prob_lm=0.0, **DIMS)
    v = to_np(jax.jit(jd.init)(jax.random.key(0), att, mask, ids, np.ones((B, L), np.int32)))
    lg = v["params"]["logit"]
    lg["kernel"] = (rng.normal(size=lg["kernel"].shape) * 2).astype(np.float32)
    td = TDec(vocab_size=VOCAB, **DIMS).eval()
    load_flax_variables(td, v)
    je = jd.apply(v, att, mask, method=jd.encode)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
    return jd, v, td, je, te, mask


def _cycle_bias(n):
    """[V+1, V+1]: a +3 log-prob bias toward a 3-cycle successor of each
    token, so that greedy decoding repeats trigrams unless they are blocked."""
    bias = np.zeros((n, n), np.float32)
    for t in range(n):
        bias[t, (t % 3) + 5] = 3.0
    return bias


def _steps(eos_from=None, **kw):
    """(jax step, torch step) over the toy decoder: log-probs with the cycle
    bias of the fed token; from step ``eos_from`` on, EOS is made likely."""
    jd, v, td, _, _, mask = _pair()
    bias = _cycle_bias(VOCAB + 1)
    tmask = torch.as_tensor(mask)

    def boost(pos):
        b = np.zeros(VOCAB + 1, np.float32)
        if eos_from is not None and pos >= eos_from:
            b[VOCAB] = 40.0
        return b

    def jstep(tok, pos, st):
        out, st = jd.apply(v, tok, pos, st, mask, method=jd.decode_step, **kw)
        eos = jnp.where(pos >= (L + 1 if eos_from is None else eos_from), 40.0, 0.0)
        return out + jnp.asarray(bias)[tok] + eos * (jnp.arange(VOCAB + 1) == VOCAB), st

    def tstep(tok, pos, st):
        out, st = td.decode_step(tok, pos, st, tmask, **kw)
        return out + torch.as_tensor(bias)[tok] + torch.as_tensor(boost(pos)), st

    return jstep, tstep


def _states(rows, length, *extra):
    jd, v, td, je, te, _ = _pair()
    return (jd.apply(v, je, rows, length, *extra, method=jd.init_decode_state),
            td.init_decode_state(te, rows, length, *extra))


# ---- the pieces ----

@pytest.mark.parametrize("t", [3, 6, 9])
def test_trigram_penalty_equals_jax(t):
    rng = np.random.default_rng(t)
    seq = rng.integers(0, 4, size=(5, 10)).astype(np.int32)     # dense with repeats
    want = np.asarray(jbeam._trigram_penalty(jnp.asarray(seq), t, 7))
    got = tbeam.trigram_penalty(torch.as_tensor(seq).long(), t, 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (want != 0).any()


def test_quantized_cache_update_equals_jax():
    rng = np.random.default_rng(0)
    new = rng.normal(size=(4, 1, 8)).astype(np.float32) * 3
    new[1] = 0.0                                                 # the 1e-8 clamp
    new[2, 0] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 0.0]     # halves: to even
    cache = rng.integers(-127, 128, size=(4, 5, 8)).astype(np.int8)
    scale = rng.random((4, 5)).astype(np.float32)
    jc, js = jlayers.quantized_cache_update(jnp.asarray(cache), jnp.asarray(scale),
                                            jnp.asarray(new), 3)
    tc, ts = torch.as_tensor(cache.copy()), torch.as_tensor(scale.copy())
    tlayers.quantized_cache_update(tc, ts, torch.as_tensor(new), 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    assert list(tc[2, 3].numpy()) == [127, 0, 2, 2, -2, 0, 4, 0]
    deq = tlayers.dequantize(tc, ts, torch.float32)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jlayers._dequantize(
        jc, js, jnp.float32)), atol=1e-6, rtol=0)


def _numpy_kept(scaled, method, k, p):
    """JAX's filter rule in numpy: top-k keeps values >= the k-th largest,
    top-p keeps values >= the sorted value where the softmax's running sum
    first reaches p."""
    if method == "top_k":
        kth = np.sort(scaled, -1)[:, ::-1][:, k - 1:k]
        return scaled >= kth
    srt = np.sort(scaled, -1)[:, ::-1]
    probs = np.exp(srt - srt.max(-1, keepdims=True))
    cum = np.cumsum(probs / probs.sum(-1, keepdims=True), -1)
    idx = np.minimum((cum < p).sum(-1), scaled.shape[-1] - 1)
    return scaled >= np.take_along_axis(srt, idx[:, None], -1)


@pytest.mark.parametrize("method,k,p", [("top_k", 3, 0.0), ("top_k", 1, 0.0),
                                        ("top_p", 0, 0.45), ("top_p", 0, 0.65)])
def test_sampler_kept_set_equals_jax_rule(method, k, p):
    """Rows with ties at the k-th value and at the top-p cutoff: row 0's
    three 0.2s tie at top-k 3's threshold, row 1's at the cutoff of both
    top-p values (running sums 0.4, 0.6, 0.8: none at a p, where float32
    rounding could fall either side)."""
    rng = np.random.default_rng(3)
    logp = np.log(rng.dirichlet(np.ones(9), size=6)).astype(np.float32)
    logp[0] = np.log([0.3, 0.2, 0.2, 0.2, 0.05, 0.05, 1e-6, 1e-6, 1e-6]).astype(np.float32)
    logp[1] = np.log([0.4, 0.2, 0.2, 0.2, 1e-9, 1e-9, 1e-9, 1e-9, 1e-9]).astype(np.float32)
    for temperature in (1.0, 0.7):
        scaled = logp / np.float32(temperature)
        got = tbeam.filter_logits(torch.as_tensor(logp), method, temperature, k, p).numpy()
        kept = got > tbeam.NEG_INF / 2
        np.testing.assert_array_equal(kept, _numpy_kept(scaled, method, k, p))
        np.testing.assert_array_equal(got[kept], scaled[kept])
        if temperature == 1.0 and k == 3:
            assert kept[0].sum() == 4                 # the tie at the 3rd value stays
        if temperature == 1.0 and method == "top_p":
            assert kept[1].sum() == 4                 # the ties at the cutoff stay


@pytest.mark.parametrize("method,temperature,k,p", [("sample", 0.7, 0, 0.0),
                                                    ("top_k", 1.0, 3, 0.0),
                                                    ("top_p", 1.3, 0, 0.8)])
def test_sampler_draws_follow_the_filtered_softmax(method, temperature, k, p):
    logp = torch.log(torch.tensor([[0.35, 0.25, 0.15, 0.1, 0.08, 0.07]]))
    draws = 40000
    gen = torch.Generator().manual_seed(5)
    sample = tbeam.make_sampler(method, temperature, k, p)
    tok = sample(logp.expand(draws, -1).contiguous(), gen).numpy()
    scaled = (logp / temperature).numpy()
    kept = _numpy_kept(scaled, method if method != "sample" else "top_k", k or 6, p)[0]
    probs = np.where(kept, np.exp(scaled[0].astype(np.float64) - scaled[0].max()), 0.0)
    probs /= probs.sum()
    counts = np.bincount(tok, minlength=6)
    assert (counts[~kept] == 0).all() and counts.sum() == draws
    chi2, pval = stats.chisquare(counts[kept], draws * probs[kept] / probs[kept].sum())
    assert pval > 1e-3, (counts, probs)


def test_sampler_limits_are_the_argmax():
    rng = np.random.default_rng(2)
    logp = torch.as_tensor(rng.normal(size=(64, 20)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    want = logp.argmax(-1)
    for method, k, p in (("top_k", 1, 0.0), ("top_p", 0, 1e-6), ("greedy", 0, 0.0)):
        assert torch.equal(tbeam.make_sampler(method, 1.0, k, p)(logp, gen), want)
    with pytest.raises(ValueError, match="top_k > 0"):
        tbeam.make_sampler("top_k", 1.0, 0, 0.0)
    with pytest.raises(ValueError, match="top_p"):
        tbeam.make_sampler("top_p", 1.0, 0, 1.5)


# ---- the loops against JAX's ----

@pytest.mark.parametrize("block_trigrams,decoding_constraint,eos_from",
                         [(False, False, None), (True, False, None), (True, True, None),
                          (True, False, 5)])
def test_greedy_sample_equals_jax(block_trigrams, decoding_constraint, eos_from):
    """Phased caches (4, 8, 12); with EOS made likely from step 5 every row
    finishes in the second phase: JAX's loop leaves at once, the port's reads
    its flag at the phase's end and leaves there, with JAX's result."""
    jstep, tstep = _steps(eos_from)
    js, ts = _states(B, 4)
    kw = dict(block_trigrams=block_trigrams, decoding_constraint=decoding_constraint,
              cache_schedule=(4, 8, 12), **IDS)
    jseq, jlp = jbeam.greedy_sample(jstep, js, B, **kw)
    loop = tbeam.SampleLoop(tstep, ts, B, **kw)
    loop.load(ts)
    tseq, tlp = loop.run()
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **SCORE_TOL)
    if eos_from is not None:
        assert loop.steps_run == 8 and loop.flag_reads == 2
    if block_trigrams and not decoding_constraint and eos_from is None:
        # the cycle bias repeats trigrams: blocking must have changed the output
        plain, _ = jbeam.greedy_sample(jstep, _states(B, 4)[0], B, **dict(
            kw, block_trigrams=False))
        assert (np.asarray(plain) != tseq.numpy()).any()


@pytest.mark.parametrize("ancestor_kv", [False, True])
def test_diverse_beam_search_equals_jax(ancestor_kv):
    jstep, tstep = _steps()
    jstates = [_states(B * 2, L)[0] for _ in range(2)]
    _, ts = _states(B * 2, L)
    kw = dict(beam_size=4, group_size=2, ancestor_kv=ancestor_kv, length_penalty="wu_0.8",
              **IDS)
    want = jbeam.diverse_beam_search(jstep, jstates, B, **kw)
    got = tbeam.diverse_beam_search(tstep, ts, B, **kw)
    np.testing.assert_array_equal(got.seqs.numpy(), np.asarray(want.seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **SCORE_TOL)
    np.testing.assert_allclose(got.alive_logp.numpy(), np.asarray(want.alive_logp),
                               **SCORE_TOL)
    assert len(np.unique(got.seqs.numpy())) > 4


@pytest.mark.parametrize("block_trigrams,decoding_constraint", [(False, False),
                                                                (True, True)])
def test_diverse_sample_greedy_equals_jax(block_trigrams, decoding_constraint):
    jstep, tstep = _steps()
    jstates = [_states(B, L)[0] for _ in range(3)]
    _, ts = _states(B, L)
    kw = dict(group_size=3, temperature=0.8, diversity_lambda=2.0,
              block_trigrams=block_trigrams, decoding_constraint=decoding_constraint, **IDS)
    jseq, jlp = jbeam.diverse_sample(jstep, jstates, B, **kw)
    tseq, tlp = tbeam.diverse_sample(tstep, ts, B, **kw)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), **SCORE_TOL)
    assert (tseq[:, 0] != tseq[:, 1]).any()          # the groups are pushed apart


@pytest.mark.parametrize("ancestor_kv", [False, True])
def test_int8_beam_search_equals_jax(ancestor_kv):
    jstep, tstep = _steps(return_logits=True)
    js, ts = _states(B * 3, 4, "int8")
    assert ts["cache_k"][0].dtype == torch.int8 and ts["cache_k_scale"][0].shape == (B * 3, 4)
    kw = dict(beam_size=3, raw_logits=True, cache_schedule=(4, 8, 12),
              ancestor_kv=ancestor_kv, **IDS)
    want = jbeam.beam_search(jstep, js, B, **kw)
    got = tbeam.beam_search(tstep, ts, B, **kw)
    np.testing.assert_array_equal(got.seqs.numpy(), np.asarray(want.seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **SCORE_TOL)


def test_sampled_tokens_lie_in_their_kept_set():
    """A top-k 2 SampleLoop (no blocking): each token a row emits while
    unfinished is one of the two largest log-probs of its step (ties kept)."""
    _, tstep = _steps()
    seen = []

    def step(tok, pos, st):
        out, st = tstep(tok, pos, st)
        seen.append(out.clone())
        return out, st

    _, ts = _states(B, L)
    loop = tbeam.SampleLoop(step, ts, B, sample_method="top_k", top_k=2, temperature=1.5,
                            block_trigrams=False, **IDS)
    loop.load(ts, seed=3)
    seq, _ = loop.run()
    assert len(seen) == L
    for r in range(B):
        for t, logp in enumerate(seen):
            tok = int(seq[r, t])
            assert logp[r, tok] >= logp[r].topk(2).values[-1], (r, t)
            if tok == VOCAB:                          # EOS: PAD from here on
                assert (seq[r, t + 1:] == IDS["pad_id"]).all()
                break


# ---- the dispatch of make_generate_step, on the tiny flagship ----

def _jax_state(v):
    return TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=None)


@pytest.mark.parametrize("cfg,mode,shape", [
    (dict(beam_size=1, sample_method="greedy", decoding_constraint=True), "sample", (2, 16)),
    (dict(beam_size=4, group_size=2, beam_kv="ancestor"), "diverse_beam", (2, 4, 16)),
    (dict(beam_size=3, kv_cache_dtype="int8"), "beam", (2, 3, 16)),
    (dict(beam_size=1, sample_method="greedy", sample_n=2, block_trigrams=False), "sample",
     (2, 2, 16)),
])
def test_generate_step_modes_match_jax(cfg, mode, shape):
    """Serving policy: greedy (trigram blocking on by default) over 8 cache
    phases, diverse beam over one full-length phase with ancestor tables, int8
    beam search on reorder caches (int8 keeps 'auto' off the lineage kernel)
    with the fused tail's plain version, greedy sample_n 2 (study-major
    rows)."""
    jm, v, tm, batch = tiny_pair(50)
    want = np.asarray(j_make(jm, Tok(50), JDecodeConfig(**cfg), 16, with_indication=True,
                             serving=True, all_samples=True)(_jax_state(v), batch))
    gen = make_generate_step(tm, Tok(50), DecodeConfig(**cfg), 16, with_indication=True,
                             serving=True, all_samples=True, device="cpu")
    assert gen.mode == mode
    assert gen.ancestor_kv == (mode == "diverse_beam")
    assert gen.fused_topk == (mode == "beam")
    got = gen(torch_batch(batch)).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3


def test_generate_step_sample_n_and_diverse_sampling_shapes():
    """sample_n rows a study, study-major (greedy: every row is the one-row
    result); diverse greedy sampling [B, G, L], whose first group no earlier
    group penalises: the greedy decode."""
    _, _, tm, batch = tiny_pair(50)
    tb = torch_batch(batch)
    kw = dict(with_indication=True, serving=False, device="cpu")
    one = make_generate_step(tm, Tok(50), DecodeConfig(beam_size=1), 16, **kw)(tb)
    three = make_generate_step(tm, Tok(50), DecodeConfig(beam_size=1, sample_n=3), 16,
                               all_samples=True, **kw)(tb)
    assert one.shape == (2, 16) and three.shape == (2, 3, 16)
    assert all(torch.equal(three[:, i], one) for i in range(3))
    div = make_generate_step(tm, Tok(50), DecodeConfig(beam_size=1, group_size=2), 16,
                             all_samples=True, **kw)
    got = div(tb)
    assert div.mode == "diverse_sample" and got.shape == (2, 2, 16)
    assert torch.equal(got[:, 0], one)


@pytest.mark.parametrize("cfg", [dict(sample_method="sample", temperature=0.7),
                                 dict(sample_method="top_k", top_k=3),
                                 dict(sample_method="top0.9"),
                                 dict(sample_method="gumbel", sample_n=3),
                                 dict(group_size=2, sample_method="top_p", top_p=0.8)])
def test_sampled_modes_reproduce_under_a_seed(cfg):
    _, _, tm, batch = tiny_pair(50)
    tb = torch_batch(batch)

    def run(seed):
        return make_generate_step(tm, Tok(50), DecodeConfig(beam_size=1, **cfg), 16,
                                  with_indication=True, all_samples=True, device="cpu",
                                  seed=seed)(tb)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) <= 50


def test_refusals():
    r2gen, cmn = SimpleNamespace(decoder_kind="r2gen"), SimpleNamespace(decoder_kind="cmn")
    with pytest.raises(NotImplementedError, match="R2Gen"):
        make_generate_step(cmn, Tok(50), DecodeConfig(kv_cache_dtype="int8"), 16, device="cpu")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        make_generate_step(r2gen, Tok(50), DecodeConfig(kv_cache_dtype="fp8"), 16,
                           device="cpu")
    with pytest.raises(ValueError, match="sample_n"):
        make_generate_step(r2gen, Tok(50), DecodeConfig(beam_size=4, group_size=2,
                                                        sample_n=3), 16, device="cpu")
    with pytest.raises(ValueError, match="top_k > 0"):
        make_generate_step(r2gen, Tok(50), DecodeConfig(beam_size=1, sample_method="top_k"),
                           16, device="cpu")
    with pytest.raises(ValueError, match="sample_method"):
        make_generate_step(r2gen, Tok(50), DecodeConfig(beam_size=1, sample_method="nucleus"),
                           16, device="cpu")
