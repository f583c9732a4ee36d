"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs CUDA and skips without it (decided inside the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on the H100's machine, where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 1e-5 (summation order); bf16 outputs 2e-2 (one bf16 ulp
near 1), top-k values 1e-2 (one bf16 ulp of the logits' scale)."""

import numpy as np
import pytest
import torch

from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk, fused_logit_topk_plain
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
