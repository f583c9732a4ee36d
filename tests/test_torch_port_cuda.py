"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs CUDA and skips without it (decided inside the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on the H100's machine, where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 1e-5 (summation order); bf16 outputs 2e-2 (one bf16 ulp
near 1), top-k values 1e-2 (one bf16 ulp of the logits' scale). The fusion
attention at float32 2e-5 (its scores sum over dk 2048 in another order)."""

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
    def test_fused_topk_kernel(self, cuda_device, dtype):
        g = torch.Generator(device=cuda_device).manual_seed(0)
        h = torch.randn(192, 512, generator=g, device=cuda_device).to(dtype)
        w = (torch.randn(3001, 512, generator=g, device=cuda_device) / 20).to(dtype)
        b = torch.randn(3001, generator=g, device=cuda_device).to(dtype)
        got = fused_logit_topk(h, w, b, 3, (4,))
        want = fused_logit_topk_plain(h, w, b, 3, (4,))
        if dtype == torch.float32:
            torch.testing.assert_close(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[0], want[0], rtol=1e-2, atol=1e-2)

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
