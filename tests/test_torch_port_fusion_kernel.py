"""Port parity: the masked cross-view fusion attention (kernel K3) and the
fusion module that calls it.

On the CPU the port's wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_pallas_ops.py does. Inputs are
made from a numpy seed. Tolerance 2e-4 at float32, as test_pallas_ops.py (the
two softmaxes sum in different orders: one dense pass against per-block
online updates)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evoke_tpu.ops.fusion_attention as jfa
from evoke_tpu.models import fusion as jf
from evoke_tpu_torch.models import fusion as tf
from evoke_tpu_torch.ops import fusion_attention as tfa
from evoke_tpu_torch.params import init_params_, load_flax_variables

from _torch_port_util import to_np

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _inputs(rng, qn, b, t, h, dk):
    n = b * t
    return (rng.normal(size=(qn, h, t, dk)).astype(np.float32),
            rng.normal(size=(h, n, dk)).astype(np.float32),
            rng.normal(size=(h, n, dk)).astype(np.float32))


def _masks():
    """The two cases of test_pallas_ops.py, and one with partnerless anchors
    (self slot only) beside anchors with 1 and 3 partners."""
    a = np.zeros((4, 6), bool)
    a[0, 1] = a[0, 4] = True
    a[1, 0] = True
    a[2, 2] = True
    a[3, 5] = a[3, 3] = a[3, 0] = True
    c = np.zeros((5, 7), bool)
    c[0, 0] = True                      # no partner: self slot
    c[1, 1] = c[1, 5] = True            # 1 partner
    c[2, 2] = True                      # no partner
    c[3, 0] = c[3, 3] = c[3, 4] = c[3, 6] = True   # 3 partners
    c[4, 6] = True                      # uneven: one sample only
    return [("pallas_ops_case", a, 8, 2, 16, 16),
            ("uneven_key_block", np.ones((2, 3), bool), 4, 1, 8, 512),
            ("partnerless_uneven", c, 5, 3, 12, 64)]


@pytest.mark.parametrize("name,attend,t,h,dk,key_block", _masks(),
                         ids=[m[0] for m in _masks()])
def test_plain_matches_jax_kernel(rng, name, attend, t, h, dk, key_block):
    q, k, v = _inputs(rng, attend.shape[0], attend.shape[1], t, h, dk)
    want = jfa.masked_cross_view_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(attend), t_tokens=t,
                                           key_block=key_block, interpret=True)
    got = tfa.masked_cross_view_attention(torch.as_tensor(q), torch.as_tensor(k),
                                          torch.as_tensor(v), torch.as_tensor(attend),
                                          t_tokens=t, key_block=key_block)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_strided_views_match_contiguous(rng):
    """The module passes views of its projection outputs: same result."""
    qn, b, t, h, dk = 3, 4, 5, 2, 8
    xq = torch.as_tensor(rng.normal(size=(qn, t, h * dk)).astype(np.float32))
    xk = torch.as_tensor(rng.normal(size=(b, t, h * dk)).astype(np.float32))
    xv = torch.as_tensor(rng.normal(size=(b, t, h * dk)).astype(np.float32))
    q = xq.reshape(qn, t, h, dk).transpose(1, 2)
    k = xk.reshape(b * t, h, dk).transpose(0, 1)
    v = xv.reshape(b * t, h, dk).transpose(0, 1)
    assert not q.is_contiguous() and not k.is_contiguous()
    attend = torch.as_tensor(np.eye(qn, b, dtype=bool) | np.eye(qn, b, 1, dtype=bool))
    got = tfa.masked_cross_view_attention(q, k, v, attend, t)
    want = tfa.masked_cross_view_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                           attend, t)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs(rng):
    q, k, v = (torch.as_tensor(x) for x in _inputs(rng, 2, 3, 4, 1, 8))
    attend = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of t_tokens"):
        tfa.masked_cross_view_attention(q, k, v, attend, t_tokens=5)
    with pytest.raises(TypeError, match="bool"):
        tfa.masked_cross_view_attention(q, k, v, attend.float(), t_tokens=4)
    with pytest.raises(TypeError, match="dtypes"):
        tfa.masked_cross_view_attention(q, k.double(), v, attend, t_tokens=4)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfa.masked_cross_view_attention(q, k, v, attend[:, :2], t_tokens=4)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tfa.masked_cross_view_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                                        v, attend, t_tokens=4)
    assert tfa.masked_cross_view_attention.launches == 0   # CPU: the plain version


@pytest.mark.parametrize("max_partners", [None, 2])
def test_module_use_pallas_matches_jax(rng, monkeypatch, max_partners):
    """BatchedCrossViewAttention(use_pallas=True): JAX (its kernel in
    interpret mode) against the port (its wrapper, plain on the CPU). With
    max_partners set both take the dense kernel route."""
    monkeypatch.setattr(jfa, "masked_cross_view_attention",
                        functools.partial(jfa.masked_cross_view_attention, interpret=True))
    d, heads, t = 16, 2, 5
    pids = np.array([0, 1, 2, 0, 1, 0, 3], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0], bool)
    x = rng.normal(size=(len(pids), t, d)).astype(np.float32)
    study = np.array(jf.same_study_matrix(pids[:3], pids, valid[:3], valid))
    jm = jf.BatchedCrossViewAttention(d, heads, wide_qkv=True, use_pallas=True,
                                      max_partners=max_partners)
    v = to_np(jm.init(jax.random.key(0), x[:3], x, study))
    want = jm.apply(v, x[:3], x, study)
    tm = tf.BatchedCrossViewAttention(d, heads, wide_qkv=True, use_pallas=True,
                                      max_partners=max_partners).eval()
    load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm(torch.as_tensor(x[:3]), torch.as_tensor(x), torch.as_tensor(study))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_module_kernel_route_matches_dense_route(rng):
    """At float32 the kernel route and the dense dot_attention route agree."""
    d, heads, t = 12, 3, 4
    pids = torch.tensor([0, 1, 2, 3, 0, 0, 2, 1, 5], dtype=torch.int32)
    valid = torch.ones(9, dtype=torch.bool)
    x = torch.as_tensor(rng.normal(size=(9, t, d)).astype(np.float32))
    study = tf.same_study_matrix(pids[:4], pids, valid[:4], valid)
    dense = init_params_(tf.BatchedCrossViewAttention(d, heads, wide_qkv=False), 1).eval()
    kern = tf.BatchedCrossViewAttention(d, heads, wide_qkv=False, use_pallas=True).eval()
    kern.load_state_dict(dense.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(kern(x[:4], x, study), dense(x[:4], x, study),
                                   rtol=1e-5, atol=1e-5)
