"""The ``mla_moe`` decoder (models/mla_moe_decoder.py) against its plain
float32 reference (tests/_ref_mla_moe.py) at a toy size on the CPU: hidden
64, 4 heads, latent 32, rope 16, one dense layer and two MoE layers of 8
experts (top 2, one shared), a vocabulary of 97. Neither imports JAX.

Tolerance of the logits at float32: 2e-4 absolute on logits of scale ~3
(largest ~9). The program and the reference compute the same float32
operations in another order and form (the absorbed attention, the grouped
expert GEMMs, a float32 residual either way): their logits differ by
1.4e-5 to 1.5e-5 in both cache modes. bfloat16 operands round at ~4e-3
relative and flip routes at near-ties: the same run in bfloat16 misses the
reference by up to 8 and a teacher-forced one by 0.37."""

import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import _ref_mla_moe as ref
from evoke_tpu_torch.core.config import MLA_MOE_KEYS, DecodeConfig, mla_moe_keys
from evoke_tpu_torch.decode.beam import BeamLoop
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.models.mla_moe_decoder import MLAMoEDecoder

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(vocab_size=97, max_position_embeddings=256, hidden_size=64, intermediate_size=128,
           moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
           num_key_value_heads=4, n_shared_experts=1, n_routed_experts=8, kv_lora_rank=32,
           qk_rope_head_dim=16, v_head_dim=16, qk_nope_head_dim=16, num_experts_per_tok=2,
           first_k_dense_replace=1)
ENC = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1, encoder_num_heads=2,
           encoder_intermediate_size=64, fusion_num_heads=2, fusion_intermediate_size=64,
           proj_num_heads=2, fusion_wide_qkv=False, max_seq_len=16)
TOL = 2e-4
V = TOY["vocab_size"]
BOS, EOS, PAD, UNK = V - 3, V - 2, 0, 4       # the port's ids for 96 words (+1 logit)


class Tok:
    bos_id, eos_id, pad_id, unk_id = BOS, EOS, PAD, UNK

    def get_vocab_size(self):
        return V - 1


def init_(module, seed):
    """N(0, 1 / fan_in) matrices (the head sharpened x3, so random weights
    make decisive beams), unit norm scales, zero biases, a small random
    routing bias (so the choice and the weights differ)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                fan = p.shape[-1] if p.dim() <= 3 else math.prod(p.shape[1:])
                w = torch.randn(p.shape, generator=g) / math.sqrt(fan)
                p.copy_(w * (3.0 if name.endswith("lm_head") else 1.0))
            else:
                p.fill_(0.0 if name.endswith("bias") or name.endswith("beta") else 1.0)
        for name, b in module.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.05)
    return module


def toy_decoder(dtype=torch.float32, seed=0):
    """The toy decoder in ``dtype`` (its router and norms stay float32)."""
    dec = MLAMoEDecoder(V - 1, 64, 16, dtype, TOY)
    dec.load_state_dict(init_(MLAMoEDecoder(V - 1, 64, 16, torch.float32, TOY), seed)
                        .state_dict())
    return dec.eval()


def params(module, prefix="text_decoder."):
    return {prefix + k: v.float() for k, v in module.state_dict().items()}


def cfg():
    return mla_moe_keys(TOY)


def att_feats(b=2, p=5, seed=1):
    return torch.randn(b, p, 64, generator=torch.Generator().manual_seed(seed))


def run_loop(dec, feats, ancestor_kv, schedule=(4, 10, 16), beam=3):
    """Prefill, then 16 cached steps of beam search through ``BeamLoop``
    (raw logits); -> (each step's logits [N, V], each row's history at it)."""
    b = feats.shape[0]
    seen = []
    with torch.inference_mode():
        enc = dec.encode(feats.to(dec.dtype))
        state0 = dec.init_decode_state(enc, b * beam, schedule[0])

        def step(tok, t, st):
            out, st = dec.decode_step(tok, t, st, return_logits=True)
            seen.append((out.float().clone(), loop.seq[:, :, :t].clone()))
            return out, st

        loop = BeamLoop(step, state0, b, bos_id=BOS, eos_id=EOS, pad_id=PAD, vocab_size=V,
                        beam_size=beam, max_len=schedule[-1], raw_logits=True,
                        early_stop=False, cache_schedule=schedule, ancestor_kv=ancestor_kv,
                        graphs=False)
        loop.load(state0)
        loop.run()
    return seen


def worst_gap(dec, feats, ancestor_kv):
    P, c = params(dec), cfg()
    worst = 0.0
    with torch.no_grad():
        for t, (lg, hist) in enumerate(run_loop(dec, feats, ancestor_kv)):
            beam = hist.shape[1]
            for s in range(feats.shape[0]):
                for k in range(beam):
                    ids = torch.tensor([BOS] + hist[s, k].tolist(), dtype=torch.long)
                    want = ref.logits(P, c, feats[s], ids)[-1]
                    worst = max(worst, float((lg[s * beam + k] - want).abs().max()))
    return worst


@pytest.mark.parametrize("ancestor_kv", [True, False], ids=["ancestor", "reorder"])
def test_prefill_then_cached_decode_matches_the_reference_logits(ancestor_kv):
    assert worst_gap(toy_decoder(), att_feats(), ancestor_kv) < TOL


def test_a_bfloat16_run_fails_the_tolerance():
    assert worst_gap(toy_decoder(torch.bfloat16), att_feats(), True) > 10 * TOL


def test_decode_train_is_the_reference_forward():
    dec, feats = toy_decoder(), att_feats()
    ids = torch.randint(5, V - 3, (2, 9), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = dec.decode_train(dec.encode(feats), None, ids, torch.ones_like(ids))
        for s in range(2):
            want = torch.log_softmax(ref.logits(params(dec), cfg(), feats[s], ids[s]), -1)
            assert (got[s] - want).abs().max() < TOL


def test_routing_is_dropless_top_k_with_weights_summing_to_the_scale():
    dec = toy_decoder()
    moe = dec.layers[1].mlp
    x32 = torch.randn(300, 64, generator=torch.Generator().manual_seed(4))
    idx, w = moe.route(x32)
    assert idx.shape == w.shape == (300, TOY["num_experts_per_tok"])
    choice = x32 @ moe.gate.t()
    choice = choice.sigmoid() + moe.e_score_correction_bias
    assert torch.equal(idx.sort(-1).values, choice.topk(2, -1).indices.sort(-1).values)
    torch.testing.assert_close(w.sum(-1), torch.full((300,), 2.446), rtol=1e-6, atol=1e-6)
    # every assignment computed: the layer equals the reference's per-token loop
    x = x32.clone()
    with torch.no_grad():
        got = moe(x, x32)
        want = ref.moe(params(dec), "text_decoder.layers.1.mlp", cfg(), x32)
    assert (got - want).abs().max() < TOL


def test_expert_ledger_counts_the_reference_routing():
    dec, feats = toy_decoder(), att_feats(b=3, p=4)
    ids = torch.randint(5, V - 3, (3, 6), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        enc = dec.encode(feats)
        st = dec.init_decode_state(enc, 3, 6)
        dec.reset_expert_ledger()
        st = dec.init_decode_state(enc, 3, 6)
        tok = torch.full((3,), BOS, dtype=torch.long)
        for t in range(6):
            _, st = dec.decode_step(tok, t, st, return_logits=True)
            tok = ids[:, t]
    led = dec.read_expert_ledger()
    want = np.zeros_like(led["rows"])          # [prefill / decode, MoE layers, experts]
    last = TOY["num_hidden_layers"] - 1
    for s in range(3):
        routing = {}
        ref.logits(params(dec), cfg(), feats[s], torch.cat([torch.tensor([BOS]), ids[s, :5]]),
                   routing=routing)
        for j, layer in enumerate(dec.moe_layers):
            for t, experts in enumerate(routing[layer]):
                if t < 4 and layer == last:
                    continue        # the prefill stops before the last layer's MLP
                for e in experts:
                    want[int(t >= 4), j, e] += 1
    assert np.array_equal(led["rows"], want)
    assert led["calls"].tolist() == [1, 6]
    assert np.array_equal(led["touched"][0], (want[0] > 0).sum(1))
    assert (led["touched"][1] <= 6 * TOY["n_routed_experts"]).all()
    assert (led["touched"][1] >= 6 * TOY["num_experts_per_tok"]).all()


def toy_model(seed=0):
    m = FinetuneModel(vocab_size=V - 1, decoder_kind="mla_moe", mla_moe=TOY, **ENC)
    return init_(m, seed).eval()


def toy_batch(rng):
    return {"images": torch.as_tensor(rng.normal(size=(4, 64, 64, 3)).astype(np.float32)),
            "ids": torch.zeros(2, 16, dtype=torch.int32),
            "pids": torch.tensor([0, 1, 0, 1], dtype=torch.int32),
            "valid": torch.ones(4, dtype=torch.bool),
            "inc_ids": torch.as_tensor(rng.integers(5, 90, (2, 16)).astype(np.int32)),
            "inc_mask": torch.ones(2, 16, dtype=torch.int32)}


def test_generate_step_beam3_is_the_reference_beam_search():
    from evoke_tpu_torch.train.steps import make_generate_step

    model, batch = toy_model(), toy_batch(np.random.default_rng(0))
    gen = make_generate_step(model, Tok(), DecodeConfig(beam_size=3, suppress_unk=True), 16,
                             with_indication=True, serving=True, device="cpu")
    assert gen.fused_topk and gen.ancestor_kv and len(gen.schedule) == 8
    seqs = gen(batch).numpy()
    with torch.no_grad():
        hidden = model.encode(batch["images"], batch["pids"], batch["valid"], 2,
                              batch["inc_ids"], batch["inc_mask"])
    P, c = params(model.text_decoder), cfg()
    for s in range(2):
        want = ref.beam_search(P, c, hidden[s, 1:], 3, 16, BOS, EOS, PAD, suppress=(UNK,))
        assert seqs[s].tolist() == want


def test_the_benchmark_reference_gives_the_test_reference_logits():
    bench = os.path.join(ROOT, "perfbench")
    if bench not in sys.path:
        sys.path.append(bench)
    from pb import ref_mla_moe as bref

    dec, feats = toy_decoder(), att_feats(b=1, p=4)
    ids = torch.randint(5, V - 3, (7,), generator=torch.Generator().manual_seed(6))
    P = params(dec)
    lm = bref.LM({k: v.to(torch.bfloat16) if v.dim() >= 2 and "gate" != k.rsplit(".", 1)[-1]
                  else v for k, v in P.items()}, cfg())
    P16 = {k: v.to(torch.bfloat16).float() if v.dim() >= 2 and not k.endswith("mlp.gate")
           else v for k, v in P.items()}
    with torch.no_grad():
        got = lm.report_logits(lm.project(feats), ids, BOS)
        want = ref.logits(P16, cfg(), feats[0], torch.cat([torch.tensor([BOS]), ids[:-1]]))
    assert (got - want).abs().max() < TOL


def test_the_continuous_engine_refuses_the_kind():
    from evoke_tpu_torch.decode.continuous import ContinuousServer

    with pytest.raises(NotImplementedError, match="mla_moe"):
        ContinuousServer(SimpleNamespace(decoder_kind="mla_moe"), Tok(), device="cpu")


def test_int8_caches_are_refused():
    from evoke_tpu_torch.train.steps import make_generate_step

    with pytest.raises(NotImplementedError, match="mla_moe"):
        make_generate_step(SimpleNamespace(decoder_kind="mla_moe"), Tok(),
                           DecodeConfig(beam_size=3, kv_cache_dtype="int8"), 16, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        toy_decoder().init_decode_state(torch.zeros(1, 2, 64), 3, 4, kv_dtype="int8")


def test_an_mp_split_is_refused():
    from evoke_tpu_torch.parallel.tp import shard_params_tp

    with pytest.raises(NotImplementedError, match="mla_moe"):
        shard_params_tp(SimpleNamespace(decoder_kind="mla_moe"), SimpleNamespace(mp=2))


def test_unimplemented_variants_and_unknown_keys_are_refused():
    for key, value in (("q_lora_rank", 1536), ("scoring_func", "softmax"), ("n_group", 8),
                       ("rope_scaling", {"type": "yarn"}), ("tie_word_embeddings", True)):
        with pytest.raises(NotImplementedError, match=key):
            mla_moe_keys({key: value})
    with pytest.raises(ValueError, match="unknown"):
        mla_moe_keys({"hidden": 1})
    with pytest.raises(ValueError, match="vocab_size"):
        MLAMoEDecoder(100, 64, 16, torch.float32, TOY)


def test_the_benchmark_configuration_carries_the_published_keys():
    path = os.path.join(ROOT, "perfbench", "configs", "evoke-kimivl-a3b-224.json")
    with open(path) as f:
        c = json.load(f)
    assert c["reduced"] == [] and c["source"].startswith("https://huggingface.co/moonshotai/")
    for key, value in MLA_MOE_KEYS.items():
        assert c[key] == value, key
    assert c["model"]["vocab_size"] + 1 == c["vocab_size"]
    assert c["model"]["d_model"] == c["hidden_size"] and c["model"]["max_seq_len"] == 128
