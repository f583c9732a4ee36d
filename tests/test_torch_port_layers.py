"""Port parity: models/layers.py building blocks, the weight bridge and device
resolution. JAX (float32, highest precision) and the port (torch CPU) see the
same numpy inputs and the same JAX-initialised weights.

Tolerance: atol 1e-5, rtol 1e-4 (float32, a few reduction-order ulps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.models import layers as jl
from evoke_tpu_torch.models import layers as tl
from evoke_tpu_torch.params import flax_to_state_dict, load_flax_variables

from _torch_port_util import to_np

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
KEY = jax.random.key(0)


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **(tol or TOL))


def _load(tm, variables):
    load_flax_variables(tm, to_np(variables))
    return tm.eval()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_torch_layer_norm(rng):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3 + 1
    jm = jl.TorchLayerNorm()
    v = jm.init(KEY, x)
    v = {"params": {"gamma": rng.normal(size=16).astype(np.float32),
                    "beta": rng.normal(size=16).astype(np.float32)}}
    tm = _load(tl.TorchLayerNorm(16), v)
    _close(jm.apply(v, x), tm(torch.as_tensor(x)))


@pytest.mark.parametrize("with_mask", [False, True])
def test_dot_attention(rng, with_mask):
    q = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    k = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    v = rng.normal(size=(2, 3, 7, 8)).astype(np.float32)
    mask = rng.random((2, 1, 5, 7)) > 0.3 if with_mask else None
    if mask is not None:
        mask[..., 0] = True
    jo, jp = jl.dot_attention(q, k, v, mask=mask)
    to, tp = tl.dot_attention(*map(torch.as_tensor, (q, k, v)),
                              mask=None if mask is None else torch.as_tensor(mask))
    _close(jo, to)
    _close(jp, tp)


@pytest.mark.parametrize("shared_kv", [False, True])
def test_mha_attend(rng, shared_kv):
    d, heads = 32, 4
    jm = jl.MultiHeadAttention(heads, d)
    x = rng.normal(size=(6, 3, d)).astype(np.float32)
    kv = rng.normal(size=(2 if shared_kv else 6, 5, d)).astype(np.float32)
    v = jm.init(KEY, x, x, x)
    tm = _load(tl.MultiHeadAttention(heads, d), v)
    mask = np.ones((kv.shape[0], 1, 1, 5), bool)
    mask[0, ..., -2:] = False
    kp, vp = jm.apply(v, kv, method=jm.project_kv)
    want = jm.apply(v, x, kp, vp, mask=mask, method=jm.attend)
    tkp, tvp = tm.project_kv(torch.as_tensor(kv))
    _close(kp, tkp)
    _close(want, tm.attend(torch.as_tensor(x), tkp, tvp, mask=torch.as_tensor(mask)))


@pytest.mark.parametrize("mode", ["causal", "ancestor", "ring", "ancestor_ring"])
def test_cached_self_attention(rng, monkeypatch, mode):
    """All decode-step branches; the JAX ancestor branch runs the Pallas
    lineage kernel in interpret mode (the port's CPU path is its plain
    version)."""
    monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
    b, kbeam, lmax, d, heads, pos = 2, 3, 8, 32, 4, 5
    n = b * kbeam
    jm = jl.MultiHeadAttention(heads, d)
    h = rng.normal(size=(n, 1, d)).astype(np.float32)
    ck = rng.normal(size=(n, lmax, d)).astype(np.float32)
    cv = rng.normal(size=(n, lmax, d)).astype(np.float32)
    v = jm.init(KEY, h, h, h)
    tm = _load(tl.MultiHeadAttention(heads, d), v)
    anc = (rng.integers(0, kbeam, size=(b, kbeam, lmax)).astype(np.int32)
           if mode.startswith("ancestor") else None)
    age = (np.repeat(np.array([3, 7], np.int32), kbeam) if mode.endswith("ring")
           else None)
    want = jm.apply(v, h, ck, cv, pos, anc, method=lambda mdl, *a:
                    jl.cached_self_attention(mdl, *a, age=age))
    t = lambda x: None if x is None else torch.as_tensor(x)
    got = tl.cached_self_attention(tm, t(h), t(ck), t(cv), pos, t(anc), age=t(age))
    _close(want, got)


def test_bert_attention_block_attend_lineage(rng, monkeypatch):
    """The lineage-kernel path of BertAttentionBlock (the BertGeneration
    decoder's route to K1) + its post-LN residual."""
    monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
    b, kbeam, lmax, d, heads, pos = 2, 3, 8, 32, 4, 6
    n = b * kbeam
    jm = jl.BertAttentionBlock(d, heads)
    x = rng.normal(size=(n, 1, d)).astype(np.float32)
    ck = rng.normal(size=(n, lmax, d)).astype(np.float32)
    cv = rng.normal(size=(n, lmax, d)).astype(np.float32)
    anc = rng.integers(0, kbeam, size=(b, kbeam, lmax)).astype(np.int32)
    v = jm.init(KEY, x, x)
    tm = _load(tl.BertAttentionBlock(d, heads), v)
    want = jm.apply(v, x, ck, cv, anc, pos, method=jm.attend_lineage)
    got = tm.attend_lineage(*map(torch.as_tensor, (x, ck, cv, anc)), pos)
    _close(want, got)


@pytest.mark.parametrize("with_age", [False, True])
def test_token_embed_at_position(rng, with_age):
    jm = jl.TokenEmbed(20, 16, max_len=50)
    ids = rng.integers(0, 20, size=(4,)).astype(np.int32)
    v = jm.init(KEY, ids[:, None])
    tm = _load(tl.TokenEmbed(20, 16, max_len=50), v)
    age = np.array([0, 3, 9, 49], np.int32) if with_age else None
    want = jm.apply(v, ids, 7, age=age, method=jm.at_position)
    got = tm.at_position(torch.as_tensor(ids), 7,
                         age=None if age is None else torch.as_tensor(age))
    _close(want, got)


def test_bert_layer_and_cross_layer(rng):
    d, heads, inter = 32, 4, 48
    x = rng.normal(size=(3, 6, d)).astype(np.float32)
    enc = rng.normal(size=(3, 4, d)).astype(np.float32)
    smask = jl.make_self_mask(jnp.asarray(np.array([[1] * 6, [1] * 4 + [0] * 2, [1] * 6])))
    cmask = jl.make_cross_mask(jnp.asarray(np.array([[1] * 4, [1] * 3 + [0], [1] * 4])))
    jb = jl.BertLayer(d, heads, inter)
    vb = jb.init(KEY, x, mask=smask)
    tb = _load(tl.BertLayer(d, heads, inter), vb)
    _close(jb.apply(vb, x, mask=smask), tb(torch.as_tensor(x), mask=torch.tensor(
        np.array(smask))))
    jc = jl.BertCrossLayer(d, heads, inter)
    vc = jc.init(KEY, x, enc, cross_mask=cmask)
    tc = _load(tl.BertCrossLayer(d, heads, inter), vc)
    _close(jc.apply(vc, x, enc, cross_mask=cmask),
           tc(torch.as_tensor(x), torch.as_tensor(enc),
              cross_mask=torch.tensor(np.array(cmask))))


def test_positionwise_ffn(rng):
    jm = jl.PositionwiseFFN(16, 40)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    v = jm.init(KEY, x)
    _close(jm.apply(v, x), _load(tl.PositionwiseFFN(16, 40), v)(torch.as_tensor(x)))


def test_weight_bridge_layouts_and_strictness():
    """Dense [in,out] -> [out,in]; conv HWIO -> OIHW; scale/embedding ->
    weight; batch stats -> running_*; any missing or unused key raises."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    conv = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    sd = flax_to_state_dict({"params": {"d": {"kernel": w, "bias": np.zeros(3)},
                                        "c": {"kernel": conv}, "n": {"scale": np.ones(3)},
                                        "e": {"embedding": w}},
                             "batch_stats": {"n": {"mean": np.zeros(3), "var": np.ones(3)}}})
    np.testing.assert_array_equal(sd["d.weight"], w.T)
    np.testing.assert_array_equal(sd["c.weight"], conv.transpose(3, 2, 0, 1))
    assert set(sd) == {"d.weight", "d.bias", "c.weight", "n.weight", "e.weight",
                       "n.running_mean", "n.running_var"}
    m = tl.Dense(3, 2)
    with pytest.raises(KeyError, match="missing"):
        load_flax_variables(m, {"params": {"kernel": w.T}})
    with pytest.raises(KeyError, match="unused"):
        load_flax_variables(m, {"params": {"kernel": w.T, "bias": np.zeros(2),
                                           "extra": {"bias": np.zeros(2)}}})
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": {"x": {"weird": np.zeros(2)}}})


def test_dense_rounds_twice_at_bf16():
    """nn.Dense(bf16): bf16(product) + bf16 bias, rounded again — not one
    rounding of product + bias."""
    m = tl.Dense(2, 1, torch.bfloat16)
    with torch.no_grad():
        m.weight.copy_(torch.tensor([[1.0, 1.0]]))
        m.bias.fill_(2.0 ** -8)
    x = torch.tensor([[1.0, 2.0 ** -8]], dtype=torch.bfloat16)
    # product 1 + 2^-8 rounds (ties-to-even) to 1; + 2^-8 rounds to 1 again
    assert m(x).item() == 1.0
    assert m(x).dtype == torch.bfloat16


def test_device_resolution_has_no_fallback():
    from evoke_tpu_torch.core.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device()
    with pytest.raises(ValueError):
        resolve_device("meta")
