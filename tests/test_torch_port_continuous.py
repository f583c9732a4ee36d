"""Port parity: the continuous-batching engine (decode/continuous.py) against
the JAX engine, on the CPU at float32.

- The engine core (``ContinuousLoop``) against the JAX ``make_segment_fn``
  (jit off) over the synthetic logit function of tests/test_continuous.py
  (per-study lengths 3..7, EOS forced at the end): 7 studies through 3 slots
  with re-admission and ring wrap, compared segment by segment (harvest
  report, host_meta, best_seq, age, base, active, alive, seq, done_seq,
  done_score) under '', 'avg_1' and 'wu_0.8'; each harvested study against a
  per-study port ``beam_search`` golden; the admission accounting.
- The ring decode step of the tiny flagship (per-row ages, ring wrap, with and
  without an ancestor table) against JAX's.
- ``ContinuousServer`` against the JAX ``ContinuousServer`` (reorder caches,
  unfused tail: JAX's CPU policy) on the tiny flagship, the JAX server run once
  per module: the port's ancestor (K1's plain ring route) and reorder modes,
  fused and unfused tails, 1 and 2 slots, 1 and 3 fused loader batches and a
  second serve() of another loader width give the same records.
- Forced lengths: the load-testing hooks on the batch path
  (``make_generate_step(logits_hook= / topk_hook=)``) and on the engine
  (``step_wrapper`` / ``topk_wrapper``) honour every study's length and agree
  report for report.
- The CLI: ``serve --decode.engine continuous`` writes the JAX CLI's
  serve_prediction.csv byte for byte; int8 caches and a non-r2gen decoder
  raise, as in JAX.

Tolerance: tokens and reports identical; scores within 1e-5 (absolute; the
running log-probs of finished beams, knocked down by 1000 a step, within
1e-6 relative)."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu import cli as jcli
from evoke_tpu.data import synthetic as jsynthetic
from evoke_tpu.data.tokenizer import WordTokenizer as JTok
from evoke_tpu.decode.continuous import ContinuousServer as JServer
from evoke_tpu.decode.continuous import init_carry as j_init_carry
from evoke_tpu.decode.continuous import make_segment_fn as j_make_segment_fn
from evoke_tpu.train.steps import TrainState
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.decode.beam import beam_search as t_beam_search
from evoke_tpu_torch.decode.continuous import ContinuousLoop, ContinuousServer
from evoke_tpu_torch.decode.forcing import force_logits, force_topk
from evoke_tpu_torch.params import flax_to_state_dict
from evoke_tpu_torch.train.steps import make_generate_step

from _torch_port_util import tiny_pair

torch.set_num_threads(1)

# ---- the engine core over a synthetic step ----

V, EOS, BOS, PAD = 13, 2, 1, 0
K, L = 2, 10
SCORE_TOL = 1e-5


def j_logits(code_rows, age_rows, tok):
    """tests/test_continuous.py's f_logits: deterministic pseudo-random logits
    per (study code, age, previous token); EOS forced at age == 3 + code % 5
    - 1 and forbidden before."""
    i = jnp.arange(V, dtype=jnp.float32)
    x = jnp.sin(code_rows[:, None] * 12.9898 + age_rows[:, None] * 78.233
                + tok[:, None] * 37.719 + i[None, :] * 3.141) * 4.0
    at_end = age_rows[:, None] == (3 + code_rows % 5 - 1)[:, None]
    is_eos = (jnp.arange(V) == EOS)[None, :]
    x = jnp.where(at_end & is_eos, 100.0, x)
    return jnp.where(~at_end & is_eos, -100.0, x)


def t_logits(code_rows, age_rows, tok):
    """``j_logits`` in torch."""
    i = torch.arange(V, dtype=torch.float32)
    x = torch.sin(code_rows[:, None] * 12.9898 + age_rows[:, None] * 78.233
                  + tok[:, None] * 37.719 + i[None, :] * 3.141) * 4.0
    at_end = age_rows[:, None] == (3 + code_rows % 5 - 1)[:, None]
    is_eos = (torch.arange(V) == EOS)[None, :]
    x = torch.where(at_end & is_eos, 100.0, x)
    return torch.where(~at_end & is_eos, -100.0, x)


def j_step(tok, p, age_rows, dec, att_mask, aux):
    return j_logits(jnp.repeat(aux, K), age_rows, tok), dec


def t_step(tok, p, age_rows, dec, att_mask, aux):
    return t_logits(aux.repeat_interleave(K), age_rows, tok), dec


def j_synth_dec(rows):
    return {"cross_k": (jnp.zeros((rows // K, 1, 1)),), "cross_v": (jnp.zeros((rows // K, 1, 1)),),
            "memory": jnp.zeros((rows, 1))}


def t_synth_dec(rows, lmax=L):
    return {"cross_k": (torch.zeros(rows // K, 1, 1),), "cross_v": (torch.zeros(rows // K, 1, 1),),
            "memory": torch.zeros(rows, 1), "cache_k": (torch.zeros(rows, lmax, 1),),
            "cache_v": (torch.zeros(rows, lmax, 1),)}


def _packs(codes, pack_size, first_ticket=0):
    """Packs of ``pack_size`` rows (the last one padded), as numpy dicts,
    with their available row counts."""
    out = []
    for i in range(0, len(codes), pack_size):
        chunk = codes[i:i + pack_size]
        out.append(({"ticket": np.arange(first_ticket + i, first_ticket + i + pack_size,
                                         dtype=np.int32),
                     "aux": np.pad(chunk, (0, pack_size - len(chunk))).astype(np.int32)},
                    len(chunk)))
    return out


def _j_pack(pk):
    e = len(pk["ticket"])
    return {"cross_k": (jnp.zeros((e, 1, 1)),), "cross_v": (jnp.zeros((e, 1, 1)),),
            "att_mask": jnp.ones((e, 1), jnp.int32), "ticket": jnp.asarray(pk["ticket"]),
            "aux": jnp.asarray(pk["aux"])}


def _t_pack(pk):
    e = len(pk["ticket"])
    return {"cross_k": (torch.zeros(e, 1, 1),), "cross_v": (torch.zeros(e, 1, 1),),
            "att_mask": torch.ones(e, 1, dtype=torch.int32),
            "ticket": torch.as_tensor(pk["ticket"]), "aux": torch.as_tensor(pk["aux"])}


def _t_loop(slots, seg_steps, length_penalty="", dispatch_segs=1):
    return ContinuousLoop(t_step, t_synth_dec(slots * K), torch.ones(slots, 1, dtype=torch.int32),
                          slots=slots, beam_size=K, seg_steps=seg_steps, bos_id=BOS,
                          eos_id=EOS, pad_id=PAD, max_len=L, length_penalty=length_penalty,
                          dispatch_segs=dispatch_segs)


def run_both(codes, slots=3, seg_steps=4, length_penalty="", pack_size=4):
    """Both engines through the same host loop of tests/test_continuous.py's
    run_engine, compared after every segment; -> {code: (seqs, scores)} of
    the port, harvested per ticket."""
    jseg = j_make_segment_fn(j_step, slots=slots, beam_size=K, seg_steps=seg_steps,
                             bos_id=BOS, eos_id=EOS, pad_id=PAD, vocab_size=V, max_len=L,
                             length_penalty=length_penalty, jit=False)
    jcarry = j_init_carry(j_synth_dec(slots * K), jnp.ones((slots, 1), jnp.int32), slots, K,
                          L, PAD, BOS)
    memory0 = jcarry["dec"]["memory"]
    loop = _t_loop(slots, seg_steps, length_penalty)
    packs = _packs(codes, pack_size)
    results, reset, cur, guard, wrapped = {}, True, -1, 0, False
    while len(results) < len(codes):
        guard += 1
        assert guard < 200, "engine failed to converge"
        idx = len(_packs(codes, pack_size)) - len(packs)
        pk, avail = packs[0] if packs else (last, 0)
        if idx != cur:
            loop.load_pack(_t_pack(pk))
            cur = idx
        last = pk
        jcarry, jout = jseg(jcarry, _j_pack(pk), jnp.int32(avail), jnp.asarray(reset), memory0)
        loop.dispatch(avail, reset)
        reset = False
        out = loop.outputs(0)
        for name in ("harvested", "tickets", "host_meta", "best_seq", "seqs"):
            np.testing.assert_array_equal(getattr(out, name).numpy(),
                                          np.asarray(getattr(jout, name)), err_msg=name)
        np.testing.assert_allclose(out.scores.numpy(), np.asarray(jout.scores), rtol=0,
                                   atol=SCORE_TOL)
        for name, buf in (("age", loop.age), ("base", loop.base), ("active", loop.active),
                          ("seq", loop.seq), ("done_seq", loop.done_seq),
                          ("ticket", loop.ticket), ("ever_fin", loop.ever_fin),
                          ("tok", loop.tok)):
            np.testing.assert_array_equal(buf.numpy(), np.asarray(jcarry[name]), err_msg=name)
        for name, buf in (("alive", loop.alive), ("done_score", loop.done_score)):
            # a finished beam's -1000 knock-downs sit where a float32 ulp is 6e-5
            np.testing.assert_allclose(buf.numpy(), np.asarray(jcarry[name]), rtol=1e-6,
                                       atol=SCORE_TOL, err_msg=name)
        assert int(loop.t) == loop.t_host == int(jcarry["t"])
        wrapped |= bool(((loop.base.numpy() + loop.age.numpy()) >= L).any())
        meta = out.host_meta.numpy()
        for s in np.nonzero(meta[:-1, 0])[0]:
            results[codes[int(meta[s, 1])]] = (out.seqs[s].numpy().copy(),
                                               out.scores[s].numpy().copy())
        if packs and meta[-1, 1] >= packs[0][1]:
            packs.pop(0)
            reset = True
    assert wrapped, "no slot's history wrapped around the ring"
    return results


def golden_for_code(code, length_penalty=""):
    """One study through the port's beam_search on the same logits."""
    def step(tok, t, st):
        return t_logits(torch.full(tok.shape, code), torch.full(tok.shape, t), tok), st

    res = t_beam_search(step, t_synth_dec(K), 1, bos_id=BOS, eos_id=EOS, pad_id=PAD,
                        vocab_size=V, beam_size=K, max_len=L, raw_logits=True,
                        length_penalty=length_penalty, early_stop=True)
    return res.seqs[0].numpy(), res.scores[0].numpy()


@pytest.mark.parametrize("length_penalty", ["", "avg_1", "wu_0.8"])
def test_segments_match_jax_and_studies_match_beam_search(length_penalty):
    codes = [0, 1, 2, 3, 4, 5, 6]
    results = run_both(codes, length_penalty=length_penalty)
    assert sorted(results) == codes
    for c in codes:
        g_seq, g_score = golden_for_code(c, length_penalty)
        seqs, scores = results[c]
        np.testing.assert_array_equal(seqs, g_seq, err_msg=f"code {c}")
        np.testing.assert_allclose(scores, g_score, rtol=0, atol=SCORE_TOL)
        assert int((seqs[0] == EOS).argmax()) + 1 == 3 + c % 5


def test_two_slots_three_step_segments_match_jax():
    results = run_both([0, 3, 6, 2], slots=2, seg_steps=3, length_penalty="avg_1")
    assert sorted(results) == [0, 2, 3, 6]


def test_dispatch_of_several_segments_equals_one_segment_dispatches():
    """dispatch_segs=3: the same carry and each segment's outputs in its own row."""
    codes = [4, 1, 6, 0, 2]
    one, three = _t_loop(2, 3), _t_loop(2, 3, dispatch_segs=3)
    (pk, avail), = _packs(codes, 5)
    for loop in (one, three):
        loop.load_pack(_t_pack(pk))
    for d in range(4):
        rows = []
        for j in range(3):
            one.dispatch(avail, d == 0 and j == 0)
            rows.append([x.clone() for x in one.outputs(0)])   # views of the output buffers
        three.dispatch(avail, d == 0)
        for j, want in enumerate(rows):
            for name, a, b in zip(three.outputs(j)._fields, three.outputs(j), want):
                assert torch.equal(a, b), (d, j, name)
        for name in ("age", "base", "active", "seq", "done_seq", "done_score", "alive", "t"):
            assert torch.equal(getattr(one, name), getattr(three, name)), name


def test_admission_accounting():
    """Free slots admit FIFO up to pack_avail; the offset lives on the device
    and resumes without a reset; JAX agrees."""
    jseg = j_make_segment_fn(j_step, slots=4, beam_size=K, seg_steps=2, bos_id=BOS,
                             eos_id=EOS, pad_id=PAD, vocab_size=V, max_len=L, jit=False)
    jcarry = j_init_carry(j_synth_dec(8), jnp.ones((4, 1), jnp.int32), 4, K, L, PAD, BOS)
    pk = {"ticket": np.asarray([10, 11, 12], np.int32), "aux": np.asarray([0, 1, 2], np.int32)}
    loop = _t_loop(4, 2)
    loop.load_pack(_t_pack(pk))
    for avail, reset, n_adm, n_active, pack_pos in ((2, True, 2, 2, 2), (3, False, 1, 3, 3)):
        jcarry, jout = jseg(jcarry, _j_pack(pk), jnp.int32(avail), jnp.asarray(reset),
                            jcarry["dec"]["memory"])
        loop.dispatch(avail, reset)
        out = loop.outputs(0)
        assert int(out.n_admitted) == int(jout.n_admitted) == n_adm
        assert not out.harvested.any()
        assert int(loop.active.sum()) == n_active
        assert int(loop.pack_pos) == int(out.host_meta[-1, 1]) == pack_pos
        np.testing.assert_array_equal(out.host_meta.numpy(), np.asarray(jout.host_meta))
    assert loop.ticket.tolist()[:3] == [10, 11, 12]
    # a reset restarts at row 0 of a (new) pack
    free = 4 - int(loop.active.sum()) + int((loop.ever_fin.all(1) & loop.active).sum())
    loop.dispatch(3, True)
    assert int(loop.outputs(0).n_admitted) == int(loop.pack_pos) == min(free, 3) > 0


def test_loop_refuses_suppression_beside_the_fused_tail():
    with pytest.raises(ValueError, match="suppress"):
        ContinuousLoop(t_step, t_synth_dec(2 * K), torch.ones(2, 1, dtype=torch.int32), slots=2,
                       beam_size=K, seg_steps=2, bos_id=BOS, eos_id=EOS, pad_id=PAD,
                       max_len=L, fused_topk=True, suppress_ids=(4,))
    loop = _t_loop(2, 2)
    with pytest.raises(RuntimeError, match="load_pack"):
        loop.dispatch(1, True)


# ---- the ring decode step of the tiny flagship ----

VOCAB = 50


@pytest.mark.parametrize("ancestor", [False, True])
@pytest.mark.parametrize("tail", ["logits", "topk"])
def test_ring_decode_step_matches_jax(ancestor, tail):
    """Three consecutive ring steps (physical slots 14, 15, 0 of 16: the last
    wraps) over samples of ages 0, 5 and 15, the per-sample lineage table
    random in ancestor mode (K1's plain ring route), against JAX's
    FinetuneModel.decode_step(age=)."""
    jm, v, tm, batch = tiny_pair(VOCAB)
    beam, lmax = 3, 16
    rng = np.random.default_rng(5)
    b = batch["ids"].shape[0]
    inc = (batch["inc_ids"], batch["inc_mask"])
    jenc, jmask = jm.apply(v, batch["images"], batch["pids"], batch["valid"], b, *inc,
                           method=jm.encode_for_decode)
    with torch.no_grad():
        tenc, tmask = tm.encode_for_decode(*(torch.as_tensor(x) for x in (
            batch["images"], batch["pids"], batch["valid"])), b,
            *(torch.as_tensor(x) for x in inc))
    # three samples: the batch's two anchors and the first again
    jenc, jmask = jnp.concatenate([jenc, jenc[:1]]), jnp.concatenate([jmask, jmask[:1]])
    tenc, tmask = torch.cat([tenc, tenc[:1]]), torch.cat([tmask, tmask[:1]])
    s = 3
    n = s * beam
    js = jm.apply(v, jenc, n, lmax, method=jm.init_decode_state)
    ts = tm.init_decode_state(tenc, n, lmax)
    # a history in every cache slot (random K/V, the same on both sides)
    for i in range(len(ts["cache_k"])):
        for key in ("cache_k", "cache_v"):
            x = rng.normal(size=ts[key][i].shape).astype(np.float32)
            ts[key][i].copy_(torch.as_tensor(x))
            js[key] = tuple(jnp.asarray(x) if j == i else c for j, c in enumerate(js[key]))
    if ancestor:
        anc = rng.integers(0, beam, size=(s, beam, lmax)).astype(np.int32)
        js["anc"], ts["anc"] = jnp.asarray(anc), torch.as_tensor(anc)
    kw = dict(return_topk=beam, topk_suppress=(4,)) if tail == "topk" else dict(return_logits=True)
    age = np.array([0, 5, 15], np.int32)
    for p in (14, 15, 0):
        tok = rng.integers(0, VOCAB + 1, size=n).astype(np.int32)
        rows = np.repeat(age, beam)
        jout, js = jm.apply(v, tok, p, js, jmask, age=jnp.asarray(rows), method=jm.decode_step,
                            **kw)
        with torch.no_grad():
            tout, ts = tm.decode_step(torch.as_tensor(tok).long(), p, ts, tmask,
                                      age=torch.as_tensor(rows), **kw)
        if tail == "topk":
            np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
            for a, bb in ((tout[0], jout[0]), (tout[2], jout[2])):
                np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ts["memory"].numpy(), np.asarray(js["memory"]), rtol=1e-4,
                                   atol=1e-5)
        for key in ("cache_k", "cache_v"):
            for a, bb in zip(ts[key], js[key]):
                np.testing.assert_allclose(a.numpy(), np.asarray(bb), rtol=1e-4, atol=1e-5)
        age = np.minimum(age + 1, lmax - 1)


# ---- the servers on the tiny flagship ----

N_STUDIES = 5


def _tokenizer(cls):
    vocab = {t: i for i, t in enumerate(["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"])}
    for i in range(VOCAB - 7):
        vocab[f"w{i}"] = len(vocab)
    return cls(vocab)


def _studies():
    """N_STUDIES studies of the tiny flagship's inputs: an anchor view, one
    auxiliary view and an indication each, from a numpy seed."""
    rng = np.random.default_rng(11)
    return [dict(id=f"st{i}", gt=f"gt {i}",
                 anchor=rng.normal(size=(32, 32, 3)).astype(np.float32),
                 aux=rng.normal(size=(32, 32, 3)).astype(np.float32),
                 inc=rng.integers(5, VOCAB - 3, size=16).astype(np.int32))
            for i in range(N_STUDIES)]


def loader(width, aux_of=None):
    """Eval-loader batches of ``width`` anchors (+ ``width`` aux slots), the
    last one padded: anchors first, then aux views; ``aux_of(study id)``
    fills the host ``_aux`` channel."""
    studies = _studies()
    batches = []
    for start in range(0, len(studies), width):
        group = studies[start:start + width]
        images = np.zeros((2 * width, 32, 32, 3), np.float32)
        pids = -np.arange(2 * width, dtype=np.int32) - 1
        valid = np.zeros(2 * width, bool)
        inc = np.zeros((width, 16), np.int32)
        for i, st in enumerate(group):
            images[i], images[width + i] = st["anchor"], st["aux"]
            pids[i] = pids[width + i] = i
            valid[i] = valid[width + i] = True
            inc[i] = st["inc"]
        pad = width - len(group)
        bt = {"images": images, "ids": np.ones((width, 16), np.int32),
              "mask": np.ones((width, 16), np.int32), "pids": pids, "valid": valid,
              "inc_ids": inc, "inc_mask": (inc != 0).astype(np.int32),
              "_image_ids": [st["id"] for st in group] + [""] * pad,
              "_gts": [st["gt"] for st in group] + [""] * pad}
        if aux_of is not None:
            bt["_aux"] = np.asarray([aux_of(st["id"]) for st in group] + [5] * pad, np.int32)
        batches.append(bt)
    return batches


@pytest.fixture(scope="module")
def jax_records():
    """The JAX ContinuousServer's records (reorder caches, unfused tail: its
    CPU policy), once per module."""
    jm, v, _, _ = tiny_pair(VOCAB)
    state = TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"], opt_state=None)
    srv = JServer(jm, _tokenizer(JTok), state, max_seq_len=16, slots=2, beam_size=3,
                  seg_steps=4)
    recs, stats = srv.serve(loader(2))
    assert stats["reports"] == N_STUDIES
    return recs


def _serve(width=2, **kw):
    _, _, tm, _ = tiny_pair(VOCAB)
    srv = ContinuousServer(tm, _tokenizer(WordTokenizer), max_seq_len=16, beam_size=3,
                           device="cpu", **{"slots": 2, "seg_steps": 4, **kw})
    return srv, srv.serve(loader(width))


@pytest.mark.parametrize("mode", ["ancestor_fused", "reorder_fused", "ancestor_unfused",
                                  "reorder_unfused"])
def test_server_matches_jax(jax_records, mode):
    beam_kv, tail = mode.split("_")
    kw = dict(beam_kv=beam_kv)
    if tail == "unfused":
        kw["step_wrapper"] = lambda raw: raw     # a step_wrapper alone keeps the raw logits
    srv, (recs, stats) = _serve(**kw)
    assert srv.ancestor_kv == (beam_kv == "ancestor") and srv.fused_topk == (tail == "fused")
    assert ("anc" in srv.loop.dec) == srv.ancestor_kv
    assert recs == jax_records
    assert len({r["report"] for r in recs}) > 1
    assert stats["reports"] == N_STUDIES and stats["reports_per_s"] > 0
    assert stats["segment_steps"] % (4 * 4) == 0 and stats["segment_steps"] > 0
    # the dispatches still in flight at the last read are issued, not consumed
    assert stats["issued_steps"] == srv.loop.steps_run >= stats["segment_steps"]
    assert stats["drain_s"] >= 0
    assert 0 < stats["drained_reports_per_s"] <= stats["reports_per_s"]
    assert stats["study_p90_ms"] >= stats["study_p50_ms"] > 0
    assert 0 < stats["service_p50_ms"] <= stats["study_p50_ms"] + 1e-6
    assert stats["capture_s"] == 0.0 and not srv.loop.graphs
    for key in ("wall_s", "encode_s", "dispatch_s", "wait_s", "service_p90_ms"):
        assert stats[key] >= 0


@pytest.mark.parametrize("kw", [dict(slots=1, seg_steps=3), dict(slots=3, seg_steps=5),
                                dict(pack_batches=1, dispatch_segs=1),
                                dict(pack_batches=3, dispatch_segs=2)],
                         ids=["slots1", "slots3", "pack1", "pack3_dispatch2"])
def test_server_is_invariant_to_slots_and_packing(jax_records, kw):
    """One slot rotates every study to another ring offset; fused packs
    compact valid rows over a padded tail; several segments a dispatch."""
    _, (recs, _) = _serve(**kw)
    assert recs == jax_records


def test_second_serve_of_another_width(jax_records):
    """A warm server serves a loader of another batch width: a new pack
    width, the same carry, the same records."""
    srv, (first, _) = _serve()
    loop = srv.loop
    second, stats = srv.serve(loader(3))
    assert srv.loop is loop and sorted(loop.packs) == [2 * 4, 3 * 4]
    assert first == second == jax_records
    assert loop.t_host > 0 and stats["reports"] == N_STUDIES


def test_server_refusals_match_jax():
    jtok, ttok = _tokenizer(JTok), _tokenizer(WordTokenizer)
    for model in (SimpleNamespace(decoder_kind="cmn"),):
        with pytest.raises(NotImplementedError, match="R2Gen"):
            JServer(model, jtok, None)
        with pytest.raises(NotImplementedError, match="R2Gen"):
            ContinuousServer(model, ttok, device="cpu")
    r2gen = SimpleNamespace(decoder_kind="r2gen")
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        JServer(r2gen, jtok, None, kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        ContinuousServer(r2gen, ttok, kv_cache_dtype="int8", device="cpu")


# ---- forced lengths through the load-testing hooks ----

def _targets():
    return {f"st{i}": 3 + (i % 4) for i in range(N_STUDIES)}


@pytest.mark.parametrize("tail", ["topk", "logits"])
def test_forced_lengths_agree_across_engines(tail):
    _, _, tm, _ = tiny_pair(VOCAB)
    tok = _tokenizer(WordTokenizer)
    eos, beam = tok.eos_id, 3
    targets = _targets()

    def rows_of(tgt, n):
        return tgt.repeat_interleave(n // tgt.shape[0])

    def topk_hook(vals, idx, lse, tok_ids, pos, batch):
        return force_topk(vals, idx, torch.full(vals.shape[:1], pos),
                          rows_of(batch["target_len"], vals.shape[0]), eos)

    def logits_hook(scores, tok_ids, pos, batch):
        return force_logits(scores, torch.full(scores.shape[:1], pos),
                     rows_of(batch["target_len"], scores.shape[0]), eos)

    hooks = dict(topk_hook=topk_hook) if tail == "topk" else dict(logits_hook=logits_hook)
    gen = make_generate_step(tm, tok, DecodeConfig(beam_size=beam), 16, with_indication=True,
                             serving=True, device="cpu", **hooks)
    assert gen.fused_topk == (tail == "topk")
    golden = {}
    for b in loader(2, aux_of=lambda i: targets[i]):
        dev = {k: torch.as_tensor(x) for k, x in b.items() if not k.startswith("_")}
        seqs = gen(dict(dev, target_len=torch.as_tensor(b["_aux"]))).numpy()
        for i, iid in enumerate(b["_image_ids"]):
            if iid:
                assert int((seqs[i] == eos).argmax()) + 1 == targets[iid], iid
                golden[iid] = tok.decode(seqs[i].tolist())

    if tail == "topk":
        def boom(raw_step):   # the fused tail must take topk_wrapper and ignore this
            raise AssertionError("step_wrapper used beside a topk_wrapper")

        kw = dict(step_wrapper=boom, topk_wrapper=lambda vals, idx, lse, age, aux: force_topk(
            vals, idx, age, aux.repeat_interleave(beam), eos))
    else:
        def step_wrapper(raw_step):
            def step(tok_ids, p, age_rows, dec, att_mask, aux):
                logits, dec = raw_step(tok_ids, p, age_rows, dec, att_mask, aux)
                return force_logits(logits, age_rows, aux.repeat_interleave(beam), eos), dec
            return step

        kw = dict(step_wrapper=step_wrapper)
    srv = ContinuousServer(tm, tok, max_seq_len=16, slots=2, beam_size=beam, seg_steps=3,
                           device="cpu", **kw)
    assert srv.fused_topk == (tail == "topk")
    recs, _ = srv.serve(loader(2, aux_of=lambda i: targets[i]))
    assert {r["id"]: r["report"] for r in recs} == golden
    assert len(set(golden.values())) > 1


# ---- the CLI ----

CLI_TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.d_model", "32",
    "--model.d_ff", "64", "--model.num_heads", "2", "--model.num_layers", "1",
    "--model.rm_num_slots", "2", "--model.rm_d_model", "32",
    "--model.fusion_num_heads", "2", "--model.fusion_intermediate_size", "64",
    "--model.image_size", "32", "--data.max_seq_len", "16",
    "--data.batch_size", "2", "--data.num_workers", "2", "--decode.beam_size", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
    "--decode.engine", "continuous", "--decode.slots", "3", "--decode.seg_steps", "4",
]


def test_serve_cli_continuous_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """Both CLIs serve the synthetic test split through the continuous engine
    with the same float32 weights (the JAX CLI's own seeded init, converted):
    the same serve_prediction.csv, byte for byte. int8 caches raise."""
    root = str(tmp_path)
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=7,
                                             image_size=32, seed=4)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results")] + CLI_TINY
    states, jserve = [], jcli._serve

    def keep_state(cfg, model, tokenizer, loaders, state):
        states.append(state)
        return jserve(cfg, model, tokenizer, loaders, state)

    monkeypatch.setattr(jcli, "_serve", keep_state)
    assert jcli.main(["serve", "--trainer.version", "jax"] + common) == 0
    (state,) = states
    weights = os.path.join(root, "weights.pt")
    tcheckpoint.save_state_dict(flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}), weights)
    capsys.readouterr()
    assert tcli.main(["serve", "--trainer.version", "torch", "--trainer.load", weights,
                      "--device", "cpu"] + common) == 0
    out = capsys.readouterr().out
    assert "'missing': 0, 'skipped': 0" in out and '"reports": 7' in out
    res = os.path.join(root, "results", "mimic_cxr", "serve")
    with open(os.path.join(res, "jax", "serve_prediction.csv"), "rb") as f:
        want = f.read()
    with open(os.path.join(res, "torch", "serve_prediction.csv"), "rb") as f:
        got = f.read()
    assert got == want
    assert got.count(b"\n") == 8
    with pytest.raises(NotImplementedError, match="kv_cache_dtype"):
        tcli.main(["serve", "--device", "cpu", "--decode.kv_cache_dtype", "int8"] + common)
