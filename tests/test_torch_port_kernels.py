"""Port parity: the two ported kernels' plain PyTorch versions against the
JAX package's Pallas kernels run in interpret mode on the CPU, plus the
wrappers' dispatch rule (a CPU tensor takes the plain version and launches
nothing; a CUDA tensor launches the kernel or raises).

The kernel-vs-plain comparisons on the card are in
tests/test_torch_port_cuda.py (and, at the main-path shapes, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from evoke_tpu.ops.fused_logit_topk import fused_logit_topk as j_fused
from evoke_tpu.ops.lineage_attention import lineage_attention as j_lineage
from evoke_tpu_torch.ops.fused_logit_topk import (fused_logit_topk,
                                                  fused_logit_topk_plain,
                                                  topk_lowest_index)
from evoke_tpu_torch.ops.lineage_attention import (lineage_attention,
                                                   lineage_attention_plain)

torch.set_num_threads(1)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _lineage_inputs(rng, b, kbeam, lmax, d):
    n = b * kbeam
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32),
            rng.integers(0, kbeam, size=(b, kbeam, lmax)).astype(np.int32))


class TestLineagePlain:
    """K1's plain version == the TPU kernel (interpret), float32: atol/rtol 1e-5."""

    @pytest.mark.parametrize("kbeam", [2, 3])
    @pytest.mark.parametrize("pos", [0, 3, 11])
    @pytest.mark.parametrize("ring", [False, True])
    def test_matches_pallas_interpret(self, rng, kbeam, pos, ring):
        b, lmax, d, heads = 4, 12, 64, 8
        q, ck, cv, anc = _lineage_inputs(rng, b, kbeam, lmax, d)
        age = np.array([0, 2, 5, 11], np.int32) if ring else None
        want = j_lineage(q, ck, cv, anc, pos, heads, interpret=True,
                         age=None if age is None else jnp.asarray(age))
        got = lineage_attention_plain(*map(torch.as_tensor, (q, ck, cv, anc)), pos, heads,
                                      age=None if age is None else torch.as_tensor(age))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5, atol=1e-5)

    def test_bf16_matches_pallas_interpret(self, rng):
        """bf16 inputs: float32 scores, probs rounded to bf16, output bf16.
        Tolerance 2 bf16 ulps of the output scale (summation order)."""
        b, kbeam, lmax, d, heads, pos = 2, 3, 8, 64, 4, 6
        q, ck, cv, anc = _lineage_inputs(rng, b, kbeam, lmax, d)
        bf = lambda x: x.astype(ml_dtypes.bfloat16)
        want = np.asarray(j_lineage(bf(q), bf(ck), bf(cv), anc, pos, heads,
                                    interpret=True)).astype(np.float32)
        tb = lambda x: torch.as_tensor(x).to(torch.bfloat16)
        got = lineage_attention_plain(tb(q), tb(ck), tb(cv), torch.as_tensor(anc), pos,
                                      heads)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(want, got.float().numpy(), atol=2 * 2 ** -8, rtol=2 ** -7)


def _bf16_ulp(x):
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


class TestFusedTopkPlain:
    """K2's plain version == the TPU kernel (interpret). float32: identical
    indices and values, lse rtol 2e-6. bf16: values within 1 bf16 ulp, indices
    equal wherever the gap to the next candidate exceeds 1 ulp; lse rtol 2e-6
    against the eager XLA recipe."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("vocab", [1003, 257, 130])
    @pytest.mark.parametrize("suppress", [(), (7, 0)])
    def test_matches_pallas_interpret(self, rng, dtype, vocab, suppress):
        n, d, k = 10, 32, 3
        h = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=(d, vocab)).astype(np.float32)
        w[:, 7] *= 10.0  # make the suppressed column a real contender
        b = (rng.normal(size=(vocab,)) * 0.1).astype(np.float32)
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        tdt = getattr(torch, dtype)
        jv, ji, jlse = j_fused(jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                               k, suppress_ids=suppress, tile=128, interpret=True)
        tv, ti, tlse = fused_logit_topk_plain(
            torch.as_tensor(h).to(tdt), torch.as_tensor(w.T.copy()).to(tdt),
            torch.as_tensor(b).to(tdt), k, suppress)
        jv, ji, jlse = np.asarray(jv), np.asarray(ji), np.asarray(jlse)
        assert tv.dtype == torch.float32 and ti.dtype == torch.int32
        if 7 in suppress:
            assert not (ti.numpy() == 7).any()
        if dtype == "float32":
            np.testing.assert_array_equal(ji, ti.numpy())
            np.testing.assert_allclose(jv, tv.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(jlse, tlse.numpy(), rtol=2e-6)
            return
        ulp = _bf16_ulp(jv)
        # bf16 lse: held against the eager XLA recipe (nn.Dense's two
        # roundings). The interpret-mode kernel's lse strays from that recipe
        # by up to 0.17 here (a dominant logit plus a nonzero bias; ROADMAP C)
        acc = jnp.dot(jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                      preferred_element_type=jnp.float32).astype(jdt)
        ref_lse = np.asarray(jax.scipy.special.logsumexp(
            (acc + jnp.asarray(b, jdt)).astype(jnp.float32), axis=-1))
        np.testing.assert_allclose(ref_lse, tlse.numpy(), rtol=2e-6)
        assert (np.abs(jv - tv.numpy()) <= ulp).all()
        gap = np.abs(np.diff(np.concatenate([jv, jv[:, -1:] - 10 * ulp[:, -1:]], 1), axis=1))
        clear = gap > ulp
        assert (ji[clear] == ti.numpy()[clear]).all()

    def test_ties_go_to_lowest_index(self):
        x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
        v, i = topk_lowest_index(x, 3)
        assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
        assert v.tolist() == [[3.0, 3.0, 3.0], [0.0, 0.0, 0.0]]


class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self, rng):
        n0, n1 = lineage_attention.launches, fused_logit_topk.launches
        q, ck, cv, anc = map(torch.as_tensor, _lineage_inputs(rng, 2, 3, 6, 32))
        out = lineage_attention(q, ck, cv, anc, 4, 4)
        torch.testing.assert_close(out, lineage_attention_plain(q, ck, cv, anc, 4, 4),
                                   rtol=0, atol=0)
        h, w, b = torch.randn(6, 32), torch.randn(40, 32), torch.randn(40)
        got = fused_logit_topk(h, w, b, 3, (4,))
        want = fused_logit_topk_plain(h, w, b, 3, (4,))
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, rtol=0, atol=0)
        assert (lineage_attention.launches, fused_logit_topk.launches) == (n0, n1)

    def test_cuda_request_without_cuda_raises(self):
        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.train.steps import make_generate_step

        from _torch_port_util import Tok

        if torch.cuda.is_available():
            pytest.skip("CUDA present: nothing to refuse")
        with pytest.raises(RuntimeError, match="cuda"):
            make_generate_step(object(), Tok(20), DecodeConfig(), 8, device="cuda")


class TestBuild:
    def test_library_is_keyed_by_source_hash(self):
        from evoke_tpu_torch.ops import _build

        for name in ("lineage_attention", "fused_logit_topk"):
            p = _build.library_path(name)
            assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
            assert p == _build.library_path(name)
        assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_missing_nvcc_raises(self, monkeypatch):
        from evoke_tpu_torch.ops import _build

        monkeypatch.setenv("PATH", "/nonexistent")
        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
