"""Port parity: the R2Gen decoder (models/rm_decoder.py) — encode, then a full
KV-cached decode step by step, the fused vocab tail of the same step, and the
bf16 dtype plan (where values are rounded, not only the final cast).

Tolerance: float32 logits atol 1e-4 (rtol 1e-4) over every step of a full
cached decode; bf16 logits within 0.1 (a few bf16 ulps at the logits' scale:
the two frameworks round the bf16 intermediate ops in different places)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.models.rm_decoder import RMDecoder as JDec
from evoke_tpu_torch.models.rm_decoder import RMDecoder as TDec
from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index
from evoke_tpu_torch.params import load_flax_variables

from _torch_port_util import to_np

torch.set_num_threads(1)
KEY = jax.random.key(0)
DIMS = dict(d_model=16, d_ff=32, d_vf=24, num_layers=2, num_heads=2, rm_num_slots=3,
            rm_d_model=16, max_seq_len=7)
VOCAB, B, BEAM, P = 30, 2, 3, 4


def _pair(dtype):
    rng = np.random.default_rng(1)
    att = rng.normal(size=(B, P, 24)).astype(np.float32)
    mask = np.ones((B, P), np.int32)
    ids = rng.integers(1, VOCAB, size=(B, 7)).astype(np.int32)
    jd = JDec(vocab_size=VOCAB, drop_prob_lm=0.0, dtype=dtype, **DIMS)
    v = to_np(jax.jit(jd.init)(KEY, att, mask, ids, np.ones((B, 7), np.int32)))
    lg = v["params"]["logit"]
    lg["kernel"] = (rng.normal(size=lg["kernel"].shape) * 2).astype(np.float32)
    td = TDec(vocab_size=VOCAB, dtype=torch.float32 if dtype == jnp.float32
              else torch.bfloat16, **DIMS).eval()
    load_flax_variables(td, v)
    return jd, v, td, att, mask, rng


def test_encode_and_full_cached_decode():
    jd, v, td, att, mask, rng = _pair(jnp.float32)
    je = jd.apply(v, att, mask, method=jd.encode)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
    np.testing.assert_allclose(np.asarray(je), te.numpy(), atol=1e-5, rtol=1e-4)
    js = jd.apply(v, je, B * BEAM, 7, method=jd.init_decode_state)
    ts = td.init_decode_state(te, B * BEAM, 7)
    tmask = torch.as_tensor(mask)
    for pos in range(7):
        tok = rng.integers(0, VOCAB + 1, size=(B * BEAM,)).astype(np.int32)
        jl, js = jd.apply(v, tok, pos, js, mask, return_logits=True, method=jd.decode_step)
        # the same step through the fused tail, on a copy (caches update in place)
        copy = dict(ts, cache_k=tuple(c.clone() for c in ts["cache_k"]),
                    cache_v=tuple(c.clone() for c in ts["cache_v"]))
        with torch.no_grad():
            tl, ts = td.decode_step(torch.as_tensor(tok), pos, ts, tmask, return_logits=True)
            (vals, idx, lse), _ = td.decode_step(torch.as_tensor(tok), pos, copy, tmask,
                                                 return_topk=BEAM, topk_suppress=(4,))
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(js["memory"]), ts["memory"].numpy(),
                                   atol=1e-5, rtol=1e-4)
        # the fused tail of the same step == top-k / logsumexp of its logits
        sup = tl.clone()
        sup[:, 4] += -1000.0
        want_v, want_i = topk_lowest_index(sup, BEAM)
        torch.testing.assert_close(idx.long(), want_i)
        torch.testing.assert_close(vals, want_v, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse, torch.logsumexp(tl, -1), rtol=1e-6, atol=1e-6)
        assert not (idx == 4).any()


def test_log_prob_output():
    jd, v, td, att, mask, rng = _pair(jnp.float32)
    je = jd.apply(v, att, mask, method=jd.encode)
    js = jd.apply(v, je, B * BEAM, 7, method=jd.init_decode_state)
    tok = rng.integers(0, VOCAB + 1, size=(B * BEAM,)).astype(np.int32)
    jl, _ = jd.apply(v, tok, 0, js, mask, method=jd.decode_step)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
        tl, _ = td.decode_step(torch.as_tensor(tok), 0, td.init_decode_state(te, B * BEAM, 7),
                               torch.as_tensor(mask))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-4, rtol=1e-4)


def test_bf16_decode_step_dtypes_and_logits():
    """bf16 compute: residual stream float32 (PE promotion), relational memory
    float32, caches bf16, logits bf16 — in both frameworks."""
    jd, v, td, att, mask, rng = _pair(jnp.bfloat16)
    je = jd.apply(v, att, mask, method=jd.encode)
    js = jd.apply(v, je, B * BEAM, 7, method=jd.init_decode_state)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
        ts = td.init_decode_state(te, B * BEAM, 7)
    assert str(je.dtype) == "bfloat16" and te.dtype == torch.bfloat16
    tmask = torch.as_tensor(mask)
    for pos in range(3):
        tok = rng.integers(0, VOCAB + 1, size=(B * BEAM,)).astype(np.int32)
        jx = jd.apply(v, tok, pos, method=lambda m, t, p: m.tgt_embed.at_position(t, p))
        tx = td.tgt_embed.at_position(torch.as_tensor(tok), pos)
        assert str(jx.dtype) == "float32" and tx.dtype == torch.float32
        jl, js = jd.apply(v, tok, pos, js, mask, return_logits=True, method=jd.decode_step)
        with torch.no_grad():
            tl, ts = td.decode_step(torch.as_tensor(tok), pos, ts, tmask, return_logits=True)
        assert str(jl.dtype) == "bfloat16" and tl.dtype == torch.bfloat16
        for key in ("cache_k", "cache_v"):
            assert str(js[key][0].dtype) == "bfloat16" and ts[key][0].dtype == torch.bfloat16
        assert str(js["memory"].dtype) == "float32" and ts["memory"].dtype == torch.float32
        np.testing.assert_allclose(np.asarray(jl, np.float32), tl.float().numpy(), atol=0.1,
                                   rtol=2e-2)


@pytest.mark.parametrize("kw", [
    dict(),                                                     # log-prob path
    dict(raw_logits=True, suppress_ids=(4,), decoding_constraint=True,
         length_penalty="wu_0.8", cache_schedule=(3, 5, 7)),
    dict(raw_logits=True, ancestor_kv=True, early_stop=False, length_penalty="avg_1.0",
         cache_schedule=(2, 7)),
])
def test_beam_search_paths_match_jax(monkeypatch, kw):
    """decode/beam.py on the same decoder weights: identical sequences and
    scores (1e-5) across the log-prob, raw-logits (suppression, decoding
    constraint, length penalties, phased caches) and ancestor paths."""
    from evoke_tpu.decode.beam import beam_search as j_beam
    from evoke_tpu_torch.decode.beam import beam_search as t_beam

    monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
    jd, v, td, att, mask, rng = _pair(jnp.float32)
    je = jd.apply(v, att, mask, method=jd.encode)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), torch.as_tensor(mask))
    lmax = kw.get("cache_schedule", (7,))[0]
    raw = kw.get("raw_logits", False)
    common = dict(bos_id=VOCAB - 1, eos_id=VOCAB, pad_id=0, vocab_size=VOCAB + 1,
                  beam_size=BEAM, max_len=7, **kw)

    def j_step(tok, pos, st):
        return jd.apply(v, tok, pos, st, mask, return_logits=raw, method=jd.decode_step)

    tmask = torch.as_tensor(mask)

    def t_step(tok, pos, st):
        return td.decode_step(tok, pos, st, tmask, return_logits=raw)

    want = j_beam(j_step, jd.apply(v, je, B * BEAM, lmax, method=jd.init_decode_state),
                  B, **common)
    got = t_beam(t_step, td.init_decode_state(te, B * BEAM, lmax), B, **common)
    np.testing.assert_array_equal(np.asarray(want.seqs), got.seqs.numpy())
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert len(np.unique(got.seqs.numpy())) > 3


def _full_decode(td, te, tmask, toks, grad=False):
    """Every step's (logits, memory) of a full cached decode of ``toks``
    [T, N] from a fresh state; ``grad``: under autograd, where the decode
    steps keep the per-norm CLN MLPs."""
    st = td.init_decode_state(te, toks.shape[1], toks.shape[0])
    out = []
    with torch.set_grad_enabled(grad):
        for pos, tok in enumerate(toks):
            tl, st = td.decode_step(torch.as_tensor(tok), pos, st, tmask, return_logits=True)
            out.append((tl.detach(), st["memory"].detach()))
    return out


@pytest.mark.parametrize("case", ["per_norm", "optimizer_step", "load_state_dict",
                                  "assign"])
def test_stacked_cln_decode(case):
    """The decode steps' stacked CLN pass (two float32 GEMMs for every
    norm's memory MLPs): per_norm, the same full cached decode through the
    per-norm MLPs (logits and memory at every step, 1e-5) and through JAX
    (1e-4); then a CLN weight changed in place by an optimizer step, copied
    in by ``load_state_dict``, or replaced by ``load_state_dict(assign=True)``:
    the next decode refreshes the pack once and equals a freshly built
    model's."""
    from evoke_tpu_torch.train.optim import build_optimizer

    jd, v, td, att, mask, rng = _pair(jnp.float32)
    toks = rng.integers(0, VOCAB + 1, size=(7, B * BEAM)).astype(np.int32)
    tmask = torch.as_tensor(mask)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), tmask)
    got = _full_decode(td, te, tmask, toks)
    assert (td.stacked_cln_steps, td.cln_pack_refreshes) == (7, 1)
    if case == "per_norm":
        want = _full_decode(td, te, tmask, toks, grad=True)
        assert (td.stacked_cln_steps, td.cln_pack_refreshes) == (7, 1)   # nothing changed
        je = jd.apply(v, att, mask, method=jd.encode)
        js = jd.apply(v, je, B * BEAM, 7, method=jd.init_decode_state)
        for pos, ((gl, gm), (wl, wm)) in enumerate(zip(got, want)):
            torch.testing.assert_close(gl, wl, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-5)
            jl, js = jd.apply(v, toks[pos], pos, js, mask, return_logits=True,
                              method=jd.decode_step)
            np.testing.assert_allclose(np.asarray(jl), gl.numpy(), atol=1e-4, rtol=1e-4)
        return
    name = "dec_1.cln2.mlp_beta_1.weight"
    if case == "optimizer_step":
        opt = build_optimizer("AdamW", "pretrain", td, pt_lr=0.05, ft_lr=0.05,
                              weight_decay=0.0)
        opt.step({name: torch.ones_like(td.get_parameter(name))})
    else:
        sd = td.state_dict()
        sd[name] = sd[name] + 0.05
        td.load_state_dict(sd, assign=case == "assign")
    after = _full_decode(td, te, tmask, toks)
    assert (td.stacked_cln_steps, td.cln_pack_refreshes) == (14, 2)
    fresh = TDec(vocab_size=VOCAB, dtype=torch.float32, **DIMS).eval()
    fresh.load_state_dict(td.state_dict())
    want = _full_decode(fresh, te, tmask, toks)
    assert not torch.equal(after[-1][0], got[-1][0])
    for (al, am), (wl, wm) in zip(after, want):
        assert torch.equal(al, wl) and torch.equal(am, wm)
