"""Port parity: tensor parallelism (parallel/tp.py) over gloo ranks on the
CPU, at float32, against the JAX package's TP placement and the port's one
device. Two spawns run every case (the rank bodies are in
``_torch_port_tp.py``, which imports no JAX):

- 2 ranks at ``dp=1 x mp=2``: the R2Gen decoder's training forward equals
  JAX's ``RMDecoder`` under ``shard_params_tp`` on a ``dp=4 x mp=2`` mesh of
  tests/conftest.py's 8 CPU devices at rtol / atol 2e-5
  (tests/test_parallel.py:50-67); a block whose heads ``mp`` does not
  divide keeps all heads (its q / k / v gathered) and equals one device;
  the wide fusion attention on 4 of 8 heads a rank (K3's route, the plain
  version here) equals the one-device module at 1e-5;
- 4 ranks at ``dp=2 x mp=2``: the rank layout and ``shard_batch`` are
  JAX's, a dp gather returns 2x rows (not 4x); the finetune and pretrain
  train steps with dropout on equal the one-rank step on the global batch
  (loss 1e-5 relative, each update within 1e-3 of RAdam's first step, the
  ResNet's within 2e-2 in L2), replicated parameters are bit-identical on
  every rank and split ones hold JAX's shard shapes; a one-device checkpoint
  restores at ``dp=2 x mp=2`` bit for bit and one written there restores
  into one device bit for bit, the next step matching; beam-3 tokens equal
  JAX's replicated decode (tests/test_parallel.py:131-163) and int8 caches
  the one-device port's, decoded eagerly (``captured`` False) with K1 and
  K2 declined; ``ReportServer`` and ``ContinuousServer`` serve the
  one-device records; the wide fusion module and its train step match one
  device.
"""

import copy
import shutil

import jax
import numpy as np
import pytest
import torch

from evoke_tpu.core import mesh as jmesh
from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.data.tokenizer import WordTokenizer as JTok
from evoke_tpu.models.rm_decoder import RMDecoder as JRMDecoder
from evoke_tpu.parallel.tp import shard_params_tp as jshard_params_tp
from evoke_tpu.train.steps import TrainState as JTrainState
from evoke_tpu.train.steps import make_generate_step as jmake_generate_step
from evoke_tpu_torch.core.checkpoint import CheckpointManager
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.models.fusion import BatchedCrossViewAttention
from evoke_tpu_torch.models.layers import MultiHeadAttention
from evoke_tpu_torch.models.pretrain import PretrainModel
from evoke_tpu_torch.models.rm_decoder import RMDecoder
from evoke_tpu_torch.params import init_params_, load_flax_variables
from evoke_tpu_torch.serve import ReportServer
from evoke_tpu_torch.train.optim import build_optimizer
from evoke_tpu_torch.train.steps import TrainState, make_generate_step

import _torch_port_dp as dpcase
import _torch_port_tp as tpcase
from _torch_port_util import TINY, damped, example_batch, tiny_pair, torch_batch

torch.set_num_threads(2)
VOCAB = 50
PRETRAIN_TINY = {k: TINY[k] for k in ("output_dim", "encoder_hidden_size",
                                      "encoder_num_layers", "encoder_num_heads",
                                      "encoder_intermediate_size", "fusion_wide_qkv")}
WIDE = dict(TINY, visual_encoder="vit_b32", d_vf=64, fusion_wide_qkv=True)
DECODER = dict(vocab_size=30, d_model=16, d_ff=32, d_vf=24, num_layers=2, num_heads=2,
               rm_num_slots=3, rm_d_model=16, max_seq_len=6, drop_prob_lm=0.0)


def _word_tokenizer(cls):
    vocab = {t: i for i, t in enumerate(["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"])}
    for i in range(VOCAB - 7):
        vocab[f"w{i}"] = len(vocab)
    return cls(vocab)


def _loader():
    """2 batches of 4 anchors + 4 aux views; the last one's fourth study is
    padding."""
    rng = np.random.default_rng(11)
    batches = []
    for i in range(2):
        b = example_batch(rng, 4, 4, 32, 16, VOCAB)
        b["_image_ids"] = [f"s{i}_{j}" for j in range(4)]
        b["_gts"] = [f"gt {i} {j}" for j in range(4)]
        if i == 1:
            b["valid"][[3, 7]] = False
            b["_image_ids"][3] = ""
        batches.append(b)
    return batches


@torch.no_grad()
def _damped(model):
    """Each Bottleneck's bn3 scale x 0.1 (a batch-statistics forward over a
    few images stays well conditioned; _torch_port_util.damped)."""
    for name, p in model.named_parameters():
        if "backbone.layer" in name and name.endswith("bn3.weight"):
            p.mul_(0.1)
    return model


def _fusion_case():
    rng = np.random.default_rng(4)
    m = BatchedCrossViewAttention(32, 8, wide_qkv=True, use_pallas=True)
    init_params_(m, 2)
    pids = torch.tensor([0, 1, 2, 0, 1, 0])
    valid = torch.ones(6, dtype=torch.bool)
    from evoke_tpu_torch.models.fusion import same_study_matrix

    study = same_study_matrix(pids[:3], pids, valid[:3], valid)
    x = torch.tensor(rng.normal(size=(6, 5, 32)), dtype=torch.float32)
    return m, (x[:3], x, study)


def _one_device_step(task, model, batch, state=None):
    return tpcase.tp_train(model, torch_batch(batch), None, task, task == "finetune",
                           state=state)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The one-device references, both spawns' inputs and results; the
    checkpoints and inputs (hundreds of MB: the ResNet and its moments) are
    removed once read."""
    d = tmp_path_factory.mktemp("tp")
    out = {}
    jm, v, tm, _ = tiny_pair(VOCAB)
    v = damped(v)
    tm = copy.deepcopy(tm)
    load_flax_variables(tm, v)
    inp = {"vocab": VOCAB, "dims": dict(TINY, dropout=0.1), "pretrain_dims": PRETRAIN_TINY,
           "rows": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
           "finetune_sd": tm.state_dict(), "one_ckpt": str(d / "one_ckpt"),
           "one_ckpt2": str(d / "one_ckpt2")}
    # the one-device finetune steps 1 and 2 (slots one_ckpt and one_ckpt2)
    fb = example_batch(np.random.default_rng(7), 2, 2, 64, 16, VOCAB)
    fb["mask"][0, 9:] = 0
    inp["finetune_batch"] = fb
    model = FinetuneModel(vocab_size=VOCAB, dropout=0.1, **TINY)
    model.load_state_dict(tm.state_dict())
    m1, state = _one_device_step("finetune", model.eval(), fb)
    CheckpointManager(inp["one_ckpt"]).save("current", state, {"epoch": 1})
    m2, state = _one_device_step("finetune", model, fb, state)
    CheckpointManager(inp["one_ckpt2"]).save("current", state, {"epoch": 2})
    inp["one_metrics"] = (m1, m2)
    del model, state
    # the one-device pretrain step
    pb = example_batch(np.random.default_rng(5), 2, 2, 64, 12, VOCAB)
    pb["mask"][0, 9:] = 0
    pb["ids"] = np.where(pb["mask"] == 1, pb["ids"], 0).astype(np.int32)
    pm = _damped(init_params_(PretrainModel(vocab_size=VOCAB, **PRETRAIN_TINY), 3)).eval()
    inp.update(pretrain_sd={k: t.clone() for k, t in pm.state_dict().items()},
               pretrain_batch=pb)
    m, _ = _one_device_step("pretrain", pm, pb)
    inp["pretrain_want"] = (m, pm.state_dict())
    # decoding: JAX's replicated beam-3 decode; the port's int8 decode and server
    decode_batch = example_batch(np.random.default_rng(1), 4, 4, 32, 16, VOCAB)
    jstate = JTrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                         opt_state=None)
    out["beam3"] = np.asarray(jmake_generate_step(
        jm, _word_tokenizer(JTok), JDecodeConfig(beam_size=3), 16,
        with_indication=True)(jstate, decode_batch))
    tok = _word_tokenizer(WordTokenizer)
    out["int8"] = make_generate_step(
        tm, tok, DecodeConfig(beam_size=3, kv_cache_dtype="int8"), 16, with_indication=True,
        serving=True, device="cpu")(torch_batch(decode_batch)).numpy()
    out["records"] = ReportServer(tm, tok, DecodeConfig(beam_size=3), 16, device="cpu").serve(
        _loader(), with_indication=True)
    inp.update(decode_batch=decode_batch, tokenizer=tok, loader=_loader())
    # the JAX shard shapes of the finetune tree's split leaves at dp=4 x mp=2
    mesh = jmesh.create_mesh(jmesh.MeshSpec(dp=4, mp=2))
    out["jax_shards"] = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jshard_params_tp(v["params"], mesh))[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        shard = leaf.sharding.shard_shape(leaf.shape)
        if key.endswith(".kernel") and shard != leaf.shape:
            out["jax_shards"][key[:-len("kernel")] + "weight"] = tuple(reversed(shard))
    # the wide fusion: the module, and a train step of the ViT model on its layout
    fm, args = _fusion_case()
    with torch.no_grad():
        out["fusion"] = fm(*args)
    wb = example_batch(np.random.default_rng(2), 2, 2, 32, 16, VOCAB)
    wm = init_params_(FinetuneModel(vocab_size=VOCAB, **WIDE), 1)
    m, _ = _one_device_step("finetune", wm, wb)
    inp.update(fusion_dims=dict(d_model=32, num_heads=8), fusion_sd=fm.state_dict(),
               fusion_args=args, wide_dims=WIDE, wide_batch=wb,
               wide_want=(m, wm.state_dict()))
    # the R2Gen decoder: JAX's TP forward; an MHA whose 3 heads mp=2 does not divide
    rng = np.random.default_rng(0)
    att = rng.normal(size=(4, 4, 24)).astype(np.float32)
    att_mask = np.ones((4, 4), np.int32)
    ids = rng.integers(1, 30, size=(4, 6)).astype(np.int32)
    tgt_mask = np.ones((4, 6), np.int32)
    jdec = JRMDecoder(**DECODER)
    dvars = jdec.init(jax.random.key(0), att, att_mask, ids, tgt_mask)
    sharded = {"params": jshard_params_tp(dvars["params"], mesh)}
    out["decoder"] = np.asarray(jax.jit(
        lambda vv: jdec.apply(vv, att, att_mask, ids, tgt_mask))(sharded))
    dec = RMDecoder(**DECODER)
    load_flax_variables(dec, jax.tree_util.tree_map(np.asarray, dvars))
    out["decode"] = tpcase.decode_logits(dec, *(torch.as_tensor(a) for a in (att, att_mask,
                                                                              ids)))
    mha = init_params_(MultiHeadAttention(3, 12), 5)
    x = torch.tensor(rng.normal(size=(2, 4, 12)), dtype=torch.float32)
    with torch.no_grad():
        out["odd_heads"] = mha(x, x, x)
    small = dict(decoder_dims=DECODER, decoder_sd=dec.state_dict(),
                 decoder_args=tuple(torch.as_tensor(a) for a in (att, att_mask, ids, tgt_mask)),
                 mha_sd=mha.state_dict(), mha_args=(x, x, x), fusion_dims=inp["fusion_dims"],
                 fusion_sd=inp["fusion_sd"], fusion_args=args)
    d4, d2 = d / "dp2mp2", d / "mp2"
    d4.mkdir()
    d2.mkdir()
    torch.save(inp, d4 / "inputs.pt")
    torch.save(small, d2 / "inputs.pt")
    del inp, tm
    ranks4 = tpcase.spawn_tp(tpcase.tp_cases, str(d4 / "inputs.pt"), dp=2, mp=2)
    ranks2 = tpcase.spawn_tp(tpcase.mp_cases, str(d2 / "inputs.pt"), dp=1, mp=2)
    # the dp x mp slot restored into one device
    model = FinetuneModel(vocab_size=VOCAB, dropout=0.1, **TINY)
    state = TrainState(model, build_optimizer("RAdam", "finetune", model, weight_decay=1e-4,
                                              **dpcase.LR))
    out["tp_ckpt_meta"] = CheckpointManager(str(d4 / "tp_ckpt")).restore("current", state)
    out["tp_ckpt"] = (state.step, tpcase.state_digest(state))
    del model, state
    for big in (d / "one_ckpt", d / "one_ckpt2", d4 / "tp_ckpt"):
        shutil.rmtree(big)
    (d4 / "inputs.pt").unlink()
    return out, ranks4, ranks2


# ---- 2 ranks, mp=2 ----

def test_r2gen_decoder_at_mp2_equals_jax_tp_decoder(devices, refs):
    out, _, ranks = refs
    for r in ranks:
        assert r["decoder_heads"] == [1, 1]        # 2 heads split over mp=2
        np.testing.assert_allclose(r["decoder"], out["decoder"], rtol=2e-5, atol=2e-5)


def test_split_cln_decode_keeps_the_per_norm_mlps(refs):
    """mp=2 splits every CLN's first-layer MLPs (``mlp_*_0``): the decode
    steps keep the per-norm path (no pack, no stacked step) and give the
    one-device decode's logits, which took the stacked pass."""
    out, _, ranks = refs
    want, stacked, packed = out["decode"]
    assert stacked == DECODER["max_seq_len"] and packed
    for r in ranks:
        got, stacked, packed = r["decode"]
        assert stacked == 0 and not packed
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_heads_that_mp_does_not_divide_keep_all_heads(refs):
    out, _, ranks = refs
    for r in ranks:
        got, heads, whole, wq_shape = r["odd_heads"]
        assert heads == 3 and whole and wq_shape == (6, 12)   # q split, then gathered
        torch.testing.assert_close(torch.as_tensor(got), out["odd_heads"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("spawn", ["mp2", "dp2mp2"])
def test_wide_fusion_on_each_ranks_heads_equals_one_device(refs, spawn):
    out, ranks4, ranks2 = refs
    for got, heads in (r["fusion"] for r in (ranks2 if spawn == "mp2" else ranks4)):
        assert heads == 4
        torch.testing.assert_close(got, out["fusion"], rtol=1e-5, atol=1e-5)


# ---- 4 ranks, dp=2 x mp=2 ----

def test_rank_layout_and_batch_rows_are_jax(devices, refs):
    _, ranks, _ = refs
    mesh = jmesh.create_mesh(jmesh.MeshSpec(dp=2, mp=2))
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jx = jmesh.shard_batch({"x": x}, mesh)["x"]
    by_device = {s.device.id: np.asarray(s.data) for s in jx.addressable_shards}
    ids = np.vectorize(lambda dv: dv.id)(mesh.devices)
    for rank, r in enumerate(ranks):
        dp_i, mp_i = r["layout"]
        assert (dp_i, mp_i) == (rank // 2, rank % 2)
        np.testing.assert_array_equal(r["rows"], by_device[ids[dp_i, mp_i]])
        assert r["gathered"] == (6, 2)           # dp=2 ranks' rows, not the world's 4


@pytest.mark.parametrize("task", ["finetune", "pretrain"])
def test_dp_mp_train_step_equals_the_global_batch_step(refs, task):
    """Every rank holds its step against the one-rank step (``check_step``);
    the replicated parameters are bit-identical on every rank, and so is
    the full (gathered) state."""
    _, ranks, _ = refs
    for r in ranks:
        assert r[task]["problems"] == []
    assert len({r[task]["replicated"] for r in ranks}) == 1
    assert len({r[task]["full"] for r in ranks}) == 1


def test_split_parameters_hold_jax_shard_shapes(refs):
    out, ranks, _ = refs
    assert len(out["jax_shards"]) > 20
    for r in ranks:
        local = {k: v for k, v in r["finetune"]["local_shapes"].items()
                 if k.endswith(".weight")}
        assert local == out["jax_shards"]


def test_checkpoint_crosses_layouts_bit_for_bit(refs):
    """A one-device slot restores at dp=2 x mp=2 bit for bit (parameters,
    statistics, moments), the next step there holds against the one-device
    second step, and the slot it saves restores into one device bit for
    bit."""
    out, ranks, _ = refs
    for r in ranks:
        got = r["restored"]
        assert got["step"] == 1 and got["meta"] == {"epoch": 1}
        assert got["unequal"] == []
        assert r["step2"]["problems"] == []
    assert out["tp_ckpt_meta"] == {"epoch": 2}
    assert out["tp_ckpt"] == (2, ranks[0]["step2"]["state"])
    assert len({r["step2"]["state"] for r in ranks}) == 1


@pytest.mark.parametrize("what", ["beam3", "int8"])
def test_dp_mp_beam3_tokens_equal_the_replicated_decode(devices, refs, what):
    """beam3: JAX's replicated decode; int8: the one-device port's."""
    out, ranks, _ = refs
    assert len({tuple(row) for row in out[what]}) > 1      # varied tokens
    for r in ranks:
        tokens, captured, ancestor, fused = r[what]
        assert not captured and not ancestor and not fused   # eager; K1 and K2 declined
        np.testing.assert_array_equal(tokens, out[what])


@pytest.mark.parametrize("engine", ["report_server", "continuous"])
def test_servers_at_dp_mp_serve_the_one_device_records(refs, engine):
    out, ranks, _ = refs
    want = out["records"]
    assert len(want) == 7
    for r in ranks:
        if engine == "report_server":
            got, captured = r["report_server"]
            assert got == want
        else:
            got, n, captured = r["continuous"]
            assert n == 7
            assert {x["id"]: x["report"] for x in got} == {x["id"]: x["report"] for x in want}
        assert captured is False


def test_wide_fusion_train_step_at_dp_mp_equals_one_device(refs):
    _, ranks, _ = refs
    for r in ranks:
        assert r["wide"]["problems"] == []
    assert len({r["wide"]["replicated"] for r in ranks}) == 1
