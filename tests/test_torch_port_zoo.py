"""Port parity: the decoder zoo (models/cmn.py, models/causal_decoder.py) and
its wiring into FinetuneModel, against the JAX package on the CPU at float32.

- Each decoder alone (toy widths, converted weights): the encoded image
  tokens, the teacher-forced log-probs (``decode_train`` through
  ``forward``) and the logits of every ``decode_step`` of a full cached
  decode, in reorder mode and over ancestor tables (the lineage route: the
  kernel's plain version here), at atol 1e-5 / rtol 1e-4
  (tests/test_torch_port_layers.py's TOL).
- Beam-3 search over each decoder alone, reorder and ancestor caches:
  identical tokens, scores within 1e-5.
- Each decoder inside the tiny FinetuneModel through make_generate_step at
  the serving policy (ancestor caches, 8 cache phases; no fused tail off
  R2Gen): tokens identical to JAX's.
- Each decoder's backward pass alone (1e-4 of a leaf's largest gradient), and
  one train step of the BertGeneration FinetuneModel (make_train_step,
  RAdam, dropout off) within tests/test_torch_port_train.py's step
  tolerances.
- The weight converter's raw leaves (memory_matrix here; cls / pos_embed in
  tests/test_torch_port_vit_heatmaps.py) and its loud failure on others.
"""

import copy
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.core import prng as jprng
from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.decode.beam import beam_search as j_beam
from evoke_tpu.train import optim as joptim
from evoke_tpu.train import steps as jsteps
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.decode.beam import beam_search as t_beam
from evoke_tpu_torch.models.causal_decoder import BertGenerationDecoder, CausalDecoder
from evoke_tpu_torch.models.cmn import CMNDecoder
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.params import flax_to_state_dict, load_flax_variables
from evoke_tpu_torch.train import optim as toptim
from evoke_tpu_torch.train import steps as tsteps

from _torch_port_util import (Tok, damped, no_dropout, recording, to_np, torch_batch,
                              zoo_pair)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-4)
VOCAB, B, P, L, D, BEAM = 30, 2, 4, 7, 16, 3
KINDS = ("cmn", "causal", "bertgen")
DIMS = dict(vocab_size=VOCAB, d_model=D, d_ff=32, d_vf=24, num_layers=2, num_heads=2,
            max_seq_len=L)


def _toy(kind):
    """(jax decoder, variables, port decoder) at toy widths, plus inputs."""
    from evoke_tpu.models.causal_decoder import (BertGenerationDecoder as JB,
                                                 CausalDecoder as JC)
    from evoke_tpu.models.cmn import CMNDecoder as JM

    extra = dict(cmm_size=40, cmm_dim=D, topk=5) if kind == "cmn" else {}
    jcls, tcls = {"cmn": (JM, CMNDecoder), "causal": (JC, CausalDecoder),
                  "bertgen": (JB, BertGenerationDecoder)}[kind]
    rng = np.random.default_rng(0)
    att = rng.normal(size=(B, P, 24)).astype(np.float32)
    mask = np.ones((B, P), np.int32)
    mask[1, 3] = 0
    ids = rng.integers(1, VOCAB, size=(B, L)).astype(np.int32)
    tmask = np.ones((B, L), np.int32)
    tmask[1, 5:] = 0
    jd = jcls(drop_prob_lm=0.0, **DIMS, **extra)
    v = to_np(jax.jit(jd.init)(jax.random.key(0), att, mask, ids, tmask))
    head = v["params"]["lm_head" if kind == "bertgen" else "logit"]
    head["kernel"] = (rng.normal(size=head["kernel"].shape) * 2).astype(np.float32)
    head["bias"] = rng.normal(size=head["bias"].shape).astype(np.float32)
    td = tcls(**DIMS, **extra).eval()
    load_flax_variables(td, v)
    return jd, v, td, att, mask, ids, tmask, rng


@pytest.mark.parametrize("kind", KINDS)
def test_decoder_matches_jax(kind):
    jd, v, td, att, mask, ids, tmask, rng = _toy(kind)
    ta, tmk = torch.as_tensor(att), torch.as_tensor(mask)
    with torch.no_grad():
        got = td(ta, tmk, torch.as_tensor(ids), torch.as_tensor(tmask))
        te = td.encode(ta, tmk)
    np.testing.assert_allclose(got.numpy(), np.asarray(jd.apply(v, att, mask, ids, tmask)),
                               **TOL)
    je = jd.apply(v, att, mask, method=jd.encode)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    # a full cached decode, reorder mode, then one over ancestor tables
    for ancestor in (False, True):
        js = jd.apply(v, je, B * BEAM, L, method=jd.init_decode_state)
        ts = td.init_decode_state(te, B * BEAM, L)
        anc = np.zeros((B, BEAM, L), np.int32)
        for pos in range(L):
            tok = rng.integers(0, VOCAB + 1, size=(B * BEAM,)).astype(np.int32)
            if ancestor:
                anc[:, :, :pos] = rng.integers(0, BEAM, size=(B, BEAM, pos))
                js, ts = dict(js, anc=jnp.asarray(anc)), dict(ts, anc=torch.as_tensor(anc))
            jl, js = jd.apply(v, tok, pos, js, mask, return_logits=True,
                              method=jd.decode_step)
            with torch.no_grad():
                tl, ts = td.decode_step(torch.as_tensor(tok).long(), pos, ts, tmk,
                                        return_logits=True)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                       err_msg=f"{kind} ancestor={ancestor} pos={pos}")


@pytest.mark.parametrize("ancestor_kv", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_beam_search_matches_jax(kind, ancestor_kv):
    jd, v, td, att, mask, *_ = _toy(kind)
    tmk = torch.as_tensor(mask)
    je = jd.apply(v, att, mask, method=jd.encode)
    with torch.no_grad():
        te = td.encode(torch.as_tensor(att), tmk)
    ids = dict(bos_id=VOCAB - 1, eos_id=VOCAB, pad_id=0, vocab_size=VOCAB + 1,
               beam_size=BEAM, max_len=L, ancestor_kv=ancestor_kv, length_penalty="wu_0.8")
    want = j_beam(lambda tok, pos, st: jd.apply(v, tok, pos, st, mask,
                                                method=jd.decode_step),
                  jd.apply(v, je, B * BEAM, L, method=jd.init_decode_state), B, **ids)
    got = t_beam(lambda tok, pos, st: td.decode_step(tok, pos, st, tmk),
                 td.init_decode_state(te, B * BEAM, L), B, **ids)
    np.testing.assert_array_equal(got.seqs.numpy(), np.asarray(want.seqs))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5,
                               atol=1e-5)
    assert len(np.unique(got.seqs.numpy())) >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_finetune_generate_matches_jax(kind):
    """The serving policy on each decoder: ancestor caches and 8 cache phases
    (JAX told beam_kv='ancestor': its 'auto' picks ancestor on a TPU only),
    the unfused tail (the fused one is R2Gen's)."""
    jm, v, tm, batch = zoo_pair(kind)
    jcfg = JDecodeConfig(beam_size=3, beam_kv="ancestor", suppress_unk=True)
    state = jsteps.TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                              opt_state=None)
    want = np.asarray(jsteps.make_generate_step(jm, Tok(50), jcfg, 16, with_indication=True,
                                                serving=True, all_samples=True)(state, batch))
    gen = tsteps.make_generate_step(tm, Tok(50), DecodeConfig(beam_size=3, suppress_unk=True),
                                    16, with_indication=True, serving=True, all_samples=True,
                                    device="cpu")
    assert gen.ancestor_kv and not gen.fused_topk and len(gen.schedule) == 8
    got = gen(torch_batch(batch)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_decoder_gradients_match_jax(kind):
    """The backward pass of each decoder alone: the gradient of the summed
    target log-probs of ``forward`` with respect to every parameter, within
    1e-4 of (the leaf's largest + 1e-3 of the largest gradient: a key bias's
    gradient is zero up to rounding)."""
    jd, v, td, att, mask, ids, tmask, _ = _toy(kind)
    onehot = np.eye(VOCAB + 1, dtype=np.float32)[ids] * tmask[..., None]

    def jloss(params):
        return (jd.apply({"params": params}, att, mask, ids, tmask) * onehot).sum()

    jgrads = flax_to_state_dict({"params": jax.grad(jloss)(v["params"])})
    td.zero_grad()
    (td(torch.as_tensor(att), torch.as_tensor(mask), torch.as_tensor(ids),
        torch.as_tensor(tmask)) * torch.as_tensor(onehot)).sum().backward()
    gmax = max(np.abs(g).max() for g in jgrads.values())
    for n, p in td.named_parameters():
        want = jgrads[n]
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * (np.abs(want).max() + 1e-3 * gmax), err_msg=n)
    if kind == "cmn":
        assert np.abs(jgrads["memory_matrix"]).max() > 0


def test_bertgen_train_step_matches_jax():
    """make_train_step on the BertGeneration FinetuneModel (RAdam, with
    indication, dropout off on both sides): the loss 1e-5 relative, the
    decoder's gradients 1e-3 of (the leaf's largest + 1e-3 of the largest
    gradient), its updated parameters within lr times the gradient difference
    plus 1e-6 relative (tests/test_torch_port_train.py). The CMN decoder's
    top-k over memory slots turns the train-mode ResNet's float32 noise (C6)
    into discrete slot swaps, so its backward pass is held alone above."""
    jm, v0, tm0, _ = zoo_pair("bertgen")
    v = damped(v0)
    rng = np.random.default_rng(11)
    from _torch_port_util import example_batch

    batch = example_batch(rng, 2, 2, 64, 16, 50)
    batch["mask"][1, 12:] = 0
    lr = dict(pt_lr=1e-2, ft_lr=3e-2, weight_decay=1e-4, grad_clip_value=0.1)
    tx = recording(joptim.build_optimizer("RAdam", "finetune", v["params"], **lr))
    jstate = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx)
    jstep = jsteps.make_train_step(jm, tx, jprng.root_key(0), with_indication=True)
    with nn.intercept_methods(no_dropout):
        jstate, jmetrics = jstep(jstate, batch)
    jgrads = flax_to_state_dict({"params": jax.device_get(jstate.opt_state[1])})
    jnew = flax_to_state_dict({"params": jax.device_get(jstate.params)})
    model = copy.deepcopy(tm0)
    load_flax_variables(model, v)
    opt = toptim.build_optimizer("RAdam", "finetune", model, **lr)
    seen = {}
    step_fn = opt.step
    opt.step = lambda grads: seen.update({k: g.clone() for k, g in grads.items()
                                          if g is not None}) or step_fn(grads)
    metrics = tsteps.make_train_step(model, opt, 0, with_indication=True, dropout=False)(
        tsteps.TrainState(model, opt), torch_batch(batch))
    assert math.isclose(float(metrics["lm"]), float(jmetrics["lm"]), rel_tol=1e-5)
    gmax = max(np.abs(g).max() for g in jgrads.values())
    decoder = [n for n in jgrads if n.startswith("text_decoder.")]
    for n in decoder:
        want = jgrads[n]
        got = seen[n].numpy() if n in seen else np.zeros_like(want)
        assert np.abs(got - want).max() <= 1e-3 * (np.abs(want).max() + 1e-3 * gmax), n
        g_err = np.abs(got - want)
        p = dict(model.named_parameters())[n].detach().numpy()
        step_lr = lr["ft_lr"] if toptim.param_label(n) == "ft" else lr["pt_lr"]
        assert (np.abs(p - jnew[n]) <= step_lr * g_err * 1.01
                + 1e-6 * np.abs(jnew[n]) + 1e-7).all(), n


def test_converter_raw_leaves_and_refusals():
    _, v, tm, _ = zoo_pair("cmn")
    sd = flax_to_state_dict({"params": {"text_decoder": {"memory_matrix": np.ones((3, 2))}}})
    assert list(sd) == ["text_decoder.memory_matrix"]
    np.testing.assert_array_equal(tm.state_dict()["text_decoder.memory_matrix"].numpy(),
                                  v["params"]["text_decoder"]["memory_matrix"])
    with pytest.raises(KeyError, match="unknown parameter leaf"):
        flax_to_state_dict({"params": {"text_decoder": {"memory_matrx": np.ones(2)}}})
    with pytest.raises(ValueError, match="decoder_kind"):
        FinetuneModel(vocab_size=10, decoder_kind="gpt9")
    with pytest.raises(ValueError, match="visual_encoder"):
        FinetuneModel(vocab_size=10, visual_encoder="vit_l14")
