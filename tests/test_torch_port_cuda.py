"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs CUDA and skips without it (decided inside the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on the H100's machine, where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 1e-5 (summation order); bf16 outputs 2e-2 (one bf16 ulp
near 1). The fused top-k: lse 1e-5 (rtol and atol); float32 values 1e-4
with identical indices; bf16 values one ulp (rtol 2^-7: the float32 sums run
in another order, so a product may round to the neighbouring bf16 value),
indices equal wherever the values differ by more than that. The fusion
attention at float32 2e-5 (its scores sum over dk 2048 in another order)."""

import math

import numpy as np
import pytest
import torch

from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk, fused_logit_topk_plain
from evoke_tpu_torch.ops.fusion_attention import (masked_cross_view_attention,
                                                  masked_cross_view_attention_plain)
from evoke_tpu_torch.ops.lineage_attention import lineage_attention, lineage_attention_plain


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100: see this file's docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lineage_inputs(rng, b, kbeam, lmax, d):
    n = b * kbeam
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32),
            rng.integers(0, kbeam, size=(b, kbeam, lmax)).astype(np.int32))


def _topk_inputs(dev, dtype, n, v, d=512, seed=0):
    """h [n, d], W [v, d] (logits ~ N(0, 1)), b [v] ~ N(0, 0.1), from numpy."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.as_tensor(x.astype(np.float32)).to(dev).to(dtype)
    return (t(rng.normal(size=(n, d))), t(rng.normal(size=(v, d)) / math.sqrt(d)),
            t(rng.normal(size=v) * 0.1))


def _assert_topk_close(got, want, dtype):
    (gv, gi, gl), (pv, pi, pl) = got, want
    assert gv.dtype == torch.float32 and gi.dtype == torch.int32 and gl.dtype == torch.float32
    torch.testing.assert_close(gl, pl, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(gi, pi, rtol=0, atol=0)
        torch.testing.assert_close(gv, pv, rtol=1e-4, atol=1e-4)
        return
    tol = pv.abs() * 2 ** -7
    assert ((gv - pv).abs() <= tol).all(), (gv - pv).abs().max().item()
    # an index may differ only where the values are within one ulp (a near-tie)
    assert not ((gi != pi) & ((gv - pv).abs() > tol)).any()


class TestOnCard:
    """Kernel vs plain version on the card (skips on the CPU)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kbeam,ring", [(3, False), (2, True), (4, False)])
    def test_lineage_kernel(self, rng, cuda_device, dtype, kbeam, ring):
        q, ck, cv, anc = _lineage_inputs(rng, 8, kbeam, 13, 512)
        dev = lambda x: torch.as_tensor(x).to(cuda_device)
        args = (dev(q).to(dtype), dev(ck).to(dtype), dev(cv).to(dtype), dev(anc))
        age = dev(np.array([0, 1, 3, 5, 7, 9, 12, 4], np.int32)) if ring else None
        n0 = lineage_attention.launches
        got = lineage_attention(*args, 9, 8, age=age)
        assert lineage_attention.launches == n0 + 1
        want = lineage_attention_plain(*args, 9, 8, age=age)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n", [6, 96, 192, 257])
    @pytest.mark.parametrize("v", [130, 3001, 30001])
    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_fused_topk_kernel(self, cuda_device, dtype, n, v, k):
        """N 257 takes a second row pass; V 3001 and 30001 end in a ragged
        tile; 4 and the first column of the second bf16 tile are suppressed."""
        h, w, b = _topk_inputs(cuda_device, dtype, n, v, seed=n + v + k)
        sup = (4, 232) if v > 232 else (4,)
        n0 = fused_logit_topk.launches
        got = fused_logit_topk(h, w, b, k, sup)
        assert fused_logit_topk.launches == n0 + 1
        _assert_topk_close(got, fused_logit_topk_plain(h, w, b, k, sup), dtype)
        assert not any((got[1] == s).any().item() for s in sup)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n_sup", [0, 1, 2, 3, 4])
    def test_fused_topk_suppression(self, cuda_device, dtype, n_sup):
        """Up to 4 suppressed ids, on both sides of the first bf16 tile
        boundary, made the largest logits so the suppression decides."""
        h, w, b = _topk_inputs(cuda_device, dtype, 192, 3001, seed=n_sup)
        sup = (231, 232, 0, 463)[:n_sup]
        for sid in sup:
            w[sid] = 3 * h.float().mean(0).to(dtype) / h.float().mean(0).norm()
        got = fused_logit_topk(h, w, b, 3, sup)
        _assert_topk_close(got, fused_logit_topk_plain(h, w, b, 3, sup), dtype)
        assert not any((got[1] == s).any().item() for s in sup)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_fused_topk_tie_across_tiles(self, cuda_device, dtype):
        """Two equal pairs on top: columns 231 (the last of bf16 tile 0) and
        232 (the first of tile 1), then 31 and 32 (float32 tiles 0 and 1).
        Each tie goes to the lower index: 231, 232, 31, 32."""
        h, w, b = _topk_inputs(cuda_device, dtype, 192, 3001, seed=7)
        h[:, 0] += 4
        for (lo, hi), scale in (((231, 232), 1.0), ((31, 32), 0.9)):
            w[lo] = 0
            w[lo, 0] = scale
            w[hi] = w[lo]
            b[hi] = b[lo]
        got = fused_logit_topk(h, w, b, 4)
        want = fused_logit_topk_plain(h, w, b, 4)
        top = want[1][:, 0] == 231
        assert top.float().mean().item() > 0.5
        torch.testing.assert_close(got[1][top], want[1][top], rtol=0, atol=0)
        assert (got[1][top, 1] == 232).all()
        _assert_topk_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_fused_topk_dominant_logit(self, cuda_device, dtype):
        """One column scaled x10 dominates the row's sum and its top-k."""
        h, w, b = _topk_inputs(cuda_device, dtype, 96, 30001, seed=11)
        w[7] *= 10
        got = fused_logit_topk(h, w, b, 3, (5,))
        _assert_topk_close(got, fused_logit_topk_plain(h, w, b, 3, (5,)), dtype)

    def test_fused_topk_more_tiles_than_sms(self, cuda_device):
        """V 40009: 173 bf16 tiles, so blocks stride over tiles."""
        h, w, b = _topk_inputs(cuda_device, torch.bfloat16, 192, 40009, seed=3)
        got = fused_logit_topk(h, w, b, 3, (4,))
        _assert_topk_close(got, fused_logit_topk_plain(h, w, b, 3, (4,)), torch.bfloat16)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("t,dk", [(50, 2048), (70, 96), (5, 16)])
    def test_fusion_attention_kernel(self, rng, cuda_device, dtype, t, dk):
        """Strided views as the module passes them; anchors with 0 (self
        slot), 1 and 3 partners; T above one 64-row tile and dk off the
        256-column chunk."""
        qn, b, h = 4, 6, 2
        dev = lambda x: torch.as_tensor(x).to(cuda_device).to(dtype)
        xq = dev(rng.normal(size=(qn, t, h * dk)).astype(np.float32))
        xk = dev(rng.normal(size=(b, t, h * dk)).astype(np.float32))
        xv = dev(rng.normal(size=(b, t, h * dk)).astype(np.float32))
        q = xq.reshape(qn, t, h, dk).transpose(1, 2)
        k = xk.reshape(b * t, h, dk).transpose(0, 1)
        v = xv.reshape(b * t, h, dk).transpose(0, 1)
        attend = np.zeros((qn, b), bool)
        attend[0, 0] = True
        attend[1, 1] = attend[1, 4] = True
        attend[2, [0, 2, 3, 5]] = True
        attend[3, 5] = True
        attend = torch.as_tensor(attend).to(cuda_device)
        n0 = masked_cross_view_attention.launches
        got = masked_cross_view_attention(q, k, v, attend, t)
        assert masked_cross_view_attention.launches == n0 + 1
        want = masked_cross_view_attention_plain(q, k, v, attend, t)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
