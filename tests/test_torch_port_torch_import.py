"""Port parity for the torch-checkpoint importers (evoke_tpu_torch/models/
torch_import.py against evoke_tpu/models/torch_import.py).

Each importer takes one state dict made from a numpy seed on both sides: the
JAX importer fills flax variables, which ``params.flax_to_state_dict`` turns
into torch keys and layouts; the port's importer fills a port module that
starts from the same weights (``params.load_flax_variables``). The two state
dicts must be bitwise equal, and the reports equal in their counts and in
the source keys they name. The inputs cover a ``module.`` prefix, a vocab
mismatch, missing tensors, GPT-2's fused ``c_attn``, a plain BERT checkpoint
into BertGeneration and ResNet-101 at reduced stage sizes (the full depth is
checked on the port alone). Last, one fabricated EVOKE checkpoint loaded
into a tiny float32 FinetuneModel gives JAX's loss (within 1e-5) and beam-3
tokens."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.models import torch_import as jti
from evoke_tpu_torch.models import torch_import as tti
from evoke_tpu_torch.models.evoke_layout import (evoke_to_port_key, finetune_layout,
                                                 finetune_state_dict)
from evoke_tpu_torch.params import flax_to_state_dict, load_flax_variables

from _torch_port_util import TINY, Tok, example_batch, no_dropout, torch_batch
from test_torch_import import _import_with_sizes, _torch_resnet_state_dict

torch.set_num_threads(1)
COUNTS = ("loaded", "mismatched", "missing")
VOCAB = 50
# the tiny flagship with the reference's wide fusion q / k / v (one head, so
# fc_q is 2048 x 2048)
WIDE = dict(TINY, fusion_wide_qkv=True, proj_num_heads=1)
LAYOUT = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
              encoder_intermediate_size=64, d_model=32, d_ff=64, num_layers=2,
              rm_num_slots=3, proj_num_heads=1, fusion_intermediate_size=64,
              sk_fusion_num_layers=1)


def filled(shapes, seed):
    """Flax variables of ``shapes`` (an eval_shape tree) from a numpy seed:
    variances in [0.5, 1.5], everything else N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(jmodule, tmodule, init_args, seed=0, method=None):
    """(JAX variables from a seed, the port module loaded with them)."""
    shapes = jax.eval_shape(functools.partial(jmodule.init, method=method),
                            jax.random.key(0), *init_args)
    v = jax.tree_util.tree_map(np.asarray, filled(shapes, seed))
    load_flax_variables(tmodule, v)
    return v, tmodule


def bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def assert_same(jrep, trep, jvars, tmodule):
    """Equal counts, equal source keys (in order), bitwise-equal tensors."""
    assert {k: trep[k] for k in COUNTS} == {k: jrep[k] for k in COUNTS}
    for lst in ("missing_keys", "mismatched_keys"):
        assert ([e.split(" -> ")[0] for e in trep.get(lst, [])]
                == [e.split(" -> ")[0] for e in jrep.get(lst, [])]), lst
    want = flax_to_state_dict(jvars)
    got = tmodule.state_dict() if isinstance(tmodule, torch.nn.Module) else tmodule
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(bits(got[k].numpy()),
                                                                 bits(w)), k


# ---------------------------------------------------------------- ResNet-101

def test_resnet_reduced_stage_sizes_match_jax():
    """Stage sizes (2, 2, 2, 2), as tests/test_torch_import.py checks the
    forward: the JAX side through that test's stage-size-general importer."""
    from evoke_tpu.models.resnet import ResNet101 as JResNet, VisualExtractor as JVX

    from evoke_tpu_torch.models.resnet import ResNet101, VisualExtractor

    stages = (2, 2, 2, 2)

    class SmallVX(JVX):
        def setup(self):
            self.backbone = JResNet(stage_sizes=stages)

    sd = {k: v.numpy() for k, v in _torch_resnet_state_dict(np.random.default_rng(0),
                                                             stages).items()}
    tvx = VisualExtractor()
    tvx.backbone = ResNet101(stage_sizes=stages)
    v, tvx = pair(SmallVX(), tvx, (jnp.zeros((1, 32, 32, 3)),))
    jv, jrep = _import_with_sizes(jti, sd, v, stages)
    _, trep = tti.import_resnet101(sd, tvx)
    assert jrep["loaded"] == len(sd) and trep["mismatched"] == trep["missing"] == 0
    assert_same(jrep, trep, jv, tvx)


def test_resnet101_full_depth_key_coverage():
    """The port alone at full depth: every torchvision tensor lands, as it is."""
    from evoke_tpu_torch.models.resnet import VisualExtractor

    sd = _torch_resnet_state_dict(np.random.default_rng(1))
    tvx = VisualExtractor()
    _, rep = tti.import_resnet101(sd, tvx)
    assert rep == {"loaded": len(sd), "mismatched": 0, "missing": 0}
    got = tvx.state_dict()
    assert len(got) == len(sd)
    assert torch.equal(got["backbone.layer3_22.conv2.weight"], sd["layer3.22.conv2.weight"])
    assert torch.equal(got["backbone.layer4_0.downsample_bn.running_var"],
                       sd["layer4.0.downsample.1.running_var"])


# ---------------------------------------------------------------- BERT encoder

def hf_bert(vocab, d, inter, layers, cross=False, positions=512, seed=0):
    """An HF BertModel (or, with ``cross``, BertGeneration encoder) state
    dict (numpy) from a seed."""
    shapes = {"embeddings.word_embeddings.weight": (vocab, d),
              "embeddings.position_embeddings.weight": (positions, d),
              "embeddings.token_type_embeddings.weight": (2, d),
              "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,),
              "pooler.dense.weight": (d, d), "pooler.dense.bias": (d,)}
    for i in range(layers):
        root = f"encoder.layer.{i}."
        for blk in ("attention", "crossattention")[:1 + cross]:
            for p in ("self.query", "self.key", "self.value", "output.dense"):
                shapes[f"{root}{blk}.{p}.weight"] = (d, d)
                shapes[f"{root}{blk}.{p}.bias"] = (d,)
            shapes[f"{root}{blk}.output.LayerNorm.weight"] = (d,)
            shapes[f"{root}{blk}.output.LayerNorm.bias"] = (d,)
        shapes.update({root + "intermediate.dense.weight": (inter, d),
                       root + "intermediate.dense.bias": (inter,),
                       root + "output.dense.weight": (d, inter), root + "output.dense.bias": (d,),
                       root + "output.LayerNorm.weight": (d,),
                       root + "output.LayerNorm.bias": (d,)})
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("case", ["plain", "bert_prefix", "vocab", "fewer_layers",
                                  "more_layers", "bf16", "state_dict"])
def test_bert_encoder_matches_jax(case):
    from evoke_tpu.models.text_encoder import TextEncoder as JEnc

    from evoke_tpu_torch.models.text_encoder import TextEncoder

    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    sd = hf_bert(60 if case == "vocab" else VOCAB, 32, 64,
                 {"fewer_layers": 1, "more_layers": 3}.get(case, 2))
    prefix = "bert." if case == "bert_prefix" else ""
    sd = {prefix + k: v for k, v in sd.items()}
    assert tti.detect_bert_prefix(sd) == jti.detect_bert_prefix(sd) == prefix
    ids = jnp.ones((1, 4), jnp.int32)
    v, tenc = pair(JEnc(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64),
                   TextEncoder(VOCAB, 32, 2, 2, 64, dtype=dtype), (ids, ids))
    jv, jrep = jti.import_bert_encoder(sd, v, prefix=prefix)
    if case == "state_dict":
        given = tenc.state_dict()
        before = {k: t.clone() for k, t in given.items()}
        out, trep = tti.import_bert_encoder(sd, given, prefix=prefix)
        assert all(torch.equal(given[k], before[k]) for k in given)
        assert_same(jrep, trep, jv, out)
        return
    _, trep = tti.import_bert_encoder(sd, tenc, prefix=prefix)
    if case == "bf16":
        want = TextEncoder(VOCAB, 32, 2, 2, 64, dtype=dtype)
        load_flax_variables(want, jv)
        assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) if
                   a.dtype == torch.bfloat16 else torch.equal(a, b) for a, b in
                   zip(tenc.state_dict().values(), want.state_dict().values()))
        assert {k: trep[k] for k in COUNTS} == {k: jrep[k] for k in COUNTS}
        return
    assert_same(jrep, trep, jv, tenc)
    assert trep["mismatched"] == (1 if case == "vocab" else 0)
    assert trep["loaded"] == 5 - trep["mismatched"] + 16 * (1 if case == "fewer_layers" else 2)


# ---------------------------------------------------------------- decoders

def gpt2_checkpoint(vocab, d=16, layers=2, positions=64, seed=0):
    """An HF GPT2LMHeadModel state dict (numpy): Conv1D weights [in, out],
    the fused c_attn [d, 3d]."""
    rng = np.random.default_rng(seed)
    shapes = {"transformer.wte.weight": (vocab, d), "transformer.wpe.weight": (positions, d),
              "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,),
              "lm_head.weight": (vocab, d)}
    for i in range(layers):
        h = f"transformer.h.{i}."
        shapes.update({h + "ln_1.weight": (d,), h + "ln_1.bias": (d,),
                       h + "attn.c_attn.weight": (d, 3 * d), h + "attn.c_attn.bias": (3 * d,),
                       h + "attn.c_proj.weight": (d, d), h + "attn.c_proj.bias": (d,),
                       h + "ln_2.weight": (d,), h + "ln_2.bias": (d,),
                       h + "mlp.c_fc.weight": (d, 4 * d), h + "mlp.c_fc.bias": (4 * d,),
                       h + "mlp.c_proj.weight": (4 * d, d), h + "mlp.c_proj.bias": (d,)})
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def decoder_init_args(d_vf, t=8):
    rng = np.random.default_rng(0)
    att = jnp.asarray(rng.normal(size=(2, 3, d_vf)), jnp.float32)
    ids = jnp.asarray(rng.integers(0, 32, (2, t)), jnp.int32)
    return att, jnp.ones((2, 3), jnp.int32), ids, jnp.ones_like(ids)


@pytest.mark.parametrize("case", ["plain", "module_prefix", "vocab", "missing_layer"])
def test_gpt2_decoder_matches_jax(case):
    from evoke_tpu.models.causal_decoder import CausalDecoder as JDec

    from evoke_tpu_torch.models.causal_decoder import CausalDecoder

    vocab, d = 32, 16
    sd = gpt2_checkpoint(vocab + (8 if case == "vocab" else 1), d,
                         layers=1 if case == "missing_layer" else 2)
    if case == "module_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    kw = dict(vocab_size=vocab, d_model=d, d_ff=4 * d, d_vf=8, num_layers=2, num_heads=2,
              max_seq_len=8, max_positions=16)
    v, tdec = pair(JDec(**kw), CausalDecoder(**kw), decoder_init_args(8))
    fresh = tdec.layer_0.cross_attn.wq.weight.detach().clone()
    jv, jrep = jti.import_gpt2_decoder(sd, v)
    _, trep = tti.import_gpt2_decoder(sd, tdec)
    assert_same(jrep, trep, jv, tdec)
    # cross-attention stays as it was; wq is the first third of c_attn, transposed
    assert torch.equal(tdec.layer_0.cross_attn.wq.weight, fresh)
    ca = sd[("module." if case == "module_prefix" else "") + "transformer.h.0.attn.c_attn.weight"]
    assert np.array_equal(tdec.layer_0.self_attn.wq.weight.detach().numpy(), ca[:, :d].T)
    want_loaded = {"plain": 37, "module_prefix": 37, "vocab": 35, "missing_layer": 21}[case]
    assert trep["loaded"] == want_loaded and trep["mismatched"] == (2 if case == "vocab" else 0)


@pytest.mark.parametrize("case", ["decoder_save", "plain_bert", "vocab"])
def test_bertgeneration_decoder_matches_jax(case):
    from evoke_tpu.models.causal_decoder import BertGenerationDecoder as JDec

    from evoke_tpu_torch.models.causal_decoder import BertGenerationDecoder

    d = 16
    vocab = 40 if case == "vocab" else 33
    sd = hf_bert(vocab, d, 2 * d, 2, cross=case != "plain_bert", positions=80, seed=3)
    if case != "plain_bert":                   # a saved BertGenerationDecoder
        rng = np.random.default_rng(4)
        sd = {"bert." + k: v for k, v in sd.items() if not k.startswith(("pooler",
                                                                         "embeddings.token"))}
        sd["lm_head.decoder.weight"] = rng.standard_normal((vocab, d)).astype(np.float32)
        sd["lm_head.bias"] = rng.standard_normal(vocab).astype(np.float32)
    kw = dict(vocab_size=32, d_model=d, d_ff=2 * d, d_vf=d, num_layers=2, num_heads=2,
              max_seq_len=6, max_positions=64)
    v, tdec = pair(JDec(**kw), BertGenerationDecoder(**kw), decoder_init_args(d, 6))
    fresh = tdec.layer_1.crossattention.wk.weight.detach().clone()
    jv, jrep = jti.import_bertgeneration_decoder(sd, v)
    _, trep = tti.import_bertgeneration_decoder(sd, tdec)
    assert_same(jrep, trep, jv, tdec)
    crossed = not torch.equal(tdec.layer_1.crossattention.wk.weight, fresh)
    assert crossed == (case != "plain_bert")
    assert trep["mismatched"] == {"decoder_save": 0, "plain_bert": 0, "vocab": 3}[case]


# ---------------------------------------------------------------- the FineTune checkpoint

@functools.lru_cache(maxsize=None)
def finetune_start(multiview=True):
    """(JAX model, its seeded variables, the port model loaded with them)."""
    from evoke_tpu.models.finetune import FinetuneModel as JModel

    from evoke_tpu_torch.models.finetune import FinetuneModel

    b = example_batch(np.random.default_rng(0), 2, 2, 32, 16, VOCAB)
    jm = JModel(vocab_size=VOCAB, drop_prob_lm=0.5, is_multiview_learning=multiview, **WIDE)
    tm = FinetuneModel(vocab_size=VOCAB, is_multiview_learning=multiview, **WIDE).eval()
    v, tm = pair(jm, tm, (b["images"], b["ids"], b["mask"], b["pids"], b["valid"],
                          b["inc_ids"], b["inc_mask"]), method=jm.warmup)
    return jm, v, tm


@functools.lru_cache(maxsize=None)
def evoke_checkpoint(vocab=VOCAB, seed=0, **dims):
    """A fabricated EVOKE FineTune state dict (numpy, float32) at the tiny
    widths, each Bottleneck's bn3 scale x 0.1 (a well-conditioned
    batch-statistics forward)."""
    sd = {k: v.numpy() for k, v in finetune_state_dict(seed, vocab,
                                                       **dict(LAYOUT, **dims)).items()}
    for k in sd:
        if k.endswith(".bn3.weight"):
            sd[k] = sd[k] * np.float32(0.1)
    return sd


def run_both(sd, multiview=True):
    jm, v, tm0 = finetune_start(multiview)
    tm = copy.deepcopy(tm0)
    jv, jrep = jti.import_finetune_checkpoint(sd, v)
    _, trep = tti.import_finetune_checkpoint(sd, tm)
    assert_same(jrep, trep, jv, tm)
    return jm, jv, tm, trep


def test_finetune_checkpoint_matches_jax():
    """The clean layout: every EVOKE tensor but the BatchNorm counters lands,
    where the second map (evoke_layout.evoke_to_port_key) says, as it is."""
    sd = evoke_checkpoint()
    _, _, tm, rep = run_both(sd)
    mapped = {k: evoke_to_port_key(k) for k in sd}
    n_mapped = sum(m is not None for m in mapped.values())
    assert rep == {"loaded": n_mapped, "mismatched": 0, "missing": 0}
    assert len(tm.state_dict()) == n_mapped
    # ResNet: bn1, 3 a block x 33, 4 downsample BNs; 2 a projection head
    assert sum(k.endswith("num_batches_tracked") for k in sd) == 1 + 3 * 33 + 4 + 2 * 2
    got = tm.state_dict()
    for k, m in mapped.items():
        if m is not None:
            want = sd[k][..., 0] if m[1] else sd[k]
            assert np.array_equal(got[m[0]].numpy(), want), k
    assert [k for k, _ in finetune_layout(VOCAB, **LAYOUT)] == list(sd)


@pytest.mark.parametrize("case", ["module_prefix", "vocab", "no_crossattention",
                                  "deeper_checkpoint"])
def test_finetune_checkpoint_edge_cases_match_jax(case):
    if case == "vocab":
        sd = evoke_checkpoint(vocab=60)
    elif case == "deeper_checkpoint":          # extra co-attention and decoder layers
        sd = evoke_checkpoint(sk_fusion_num_layers=2, num_layers=3)
    else:
        sd = dict(evoke_checkpoint())
    if case == "module_prefix":
        sd = {"module." + k: v for k, v in sd.items()}
    if case == "no_crossattention":
        sd = {k: v for k, v in sd.items()
              if not k.startswith("multimodal_fusion_layers.0.crossattention.")}
    _, _, _, rep = run_both(sd)
    want = {"module_prefix": (0, 0), "vocab": (4, 0), "no_crossattention": (0, 3),
            "deeper_checkpoint": (0, 0)}[case]
    assert (rep["mismatched"], rep["missing"]) == want


def test_finetune_checkpoint_into_a_model_without_multiview_fusion():
    """No fusion.cross / layer_norm_2 in the model: 10 missing, keyed."""
    _, _, _, rep = run_both(evoke_checkpoint(), multiview=False)
    assert rep["missing"] == 10 and rep["mismatched"] == 0
    assert [e.split(" -> ")[0] for e in rep["missing_keys"]] == (
        ["layer_norm_2"] * 2 + [fc for fc in ("fc_q", "fc_k", "fc_v", "fc_o") for _ in "wb"])


def test_loaded_checkpoint_gives_jax_loss_and_beams(tmp_path):
    """One fabricated EVOKE checkpoint, written as model_best.pth and loaded
    on both sides: the training forward's loss, with batch statistics (no
    dropout) and with the running ones, within 1e-5 (relative), and beam-3
    tokens identical, at float32."""
    import flax.linen as fnn

    from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
    from evoke_tpu.train.steps import TrainState, make_generate_step as j_make
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.train.steps import make_generate_step

    path = tmp_path / "model_best.pth"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in evoke_checkpoint().items()}},
               path)
    jm, v, tm0 = finetune_start()
    tm = copy.deepcopy(tm0)
    jv, jrep = jti.load_finetune_checkpoint(str(path), v)
    _, trep = tti.load_finetune_checkpoint(str(path), tm)
    assert_same(jrep, trep, jv, tm)

    # 64 px: layer4's batch statistics then pool 16 values a channel, not 4
    b = example_batch(np.random.default_rng(1), 2, 2, 64, 16, VOCAB)
    args = (b["images"], b["ids"], b["mask"], b["pids"], b["valid"], b["inc_ids"],
            b["inc_mask"])
    for train in (True, False):
        with fnn.intercept_methods(no_dropout):
            jout, _ = jm.apply(jv, *args, train=train, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.key(0)})
        with torch.no_grad():
            tout = tm(*(torch.as_tensor(a) for a in args), train=train)
        assert abs(float(tout["lm"]) - float(jout["lm"])) <= 1e-5 * abs(float(jout["lm"]))

    jstate = TrainState(step=0, params=jv["params"], batch_stats=jv["batch_stats"],
                        opt_state=None)
    want = np.asarray(j_make(jm, Tok(VOCAB), JDecodeConfig(beam_size=3), 16,
                             with_indication=True, serving=False, all_samples=True)(jstate, b))
    tm.eval()
    got = make_generate_step(tm, Tok(VOCAB), DecodeConfig(beam_size=3), 16,
                             with_indication=True, serving=False, all_samples=True,
                             device="cpu")(torch_batch(b)).numpy()
    np.testing.assert_array_equal(want, got)
    assert len(np.unique(got)) > 3
