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
from evoke_tpu_torch.ops.fused_logit_topk import (BF16_TILE, SMEM_LIMIT, fused_logit_topk,
                                                  fused_logit_topk_plain, launch_plan,
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


class TestLaunchPlan:
    """The bf16 route's launch plan (ops/fused_logit_topk.launch_plan), which
    csrc/fused_logit_topk.cu takes as given: one wave of 232-column tiles at
    V 30001, row passes of <= 192 rows, and a ring that fits 227 KB."""

    @pytest.mark.parametrize("n", [6, 96, 192, 257])
    @pytest.mark.parametrize("v", [130, 3001, 30001])
    @pytest.mark.parametrize("k", [1, 3, 8])
    def test_plan_fits_the_card(self, n, v, k):
        p = launch_plan(n, 512, v, k)
        assert p["tiles"] == -(-v // BF16_TILE) and p["grid"] == min(p["tiles"], 132)
        assert p["row_pass"] % 64 == 0 and min(n, 192) <= p["row_pass"] <= 192
        assert p["passes"] * p["row_pass"] >= n > (p["passes"] - 1) * p["row_pass"]
        assert p["warpgroups"] == p["row_pass"] // 64 and p["threads"] == 128 * p["warpgroups"]
        assert 2 <= p["stages"] <= 4 and p["depth_steps"] == 8
        assert p["stage_bytes"] == (p["row_pass"] + BF16_TILE) * 128
        assert p["smem_bytes"] == (1024 + p["stages"] * (p["stage_bytes"] + 16)
                                   + 3 * BF16_TILE)
        assert p["smem_bytes"] <= SMEM_LIMIT
        assert p["partial_floats"] == p["tiles"] * n * (2 + 2 * k)

    def test_serving_shapes(self):
        """Flagship N 192 and CLI N 96 at V 30001: 130 tiles in one wave on
        132 SMs, 4 stages, 0.8 MB of partials at k 3."""
        flag, cli = launch_plan(192, 512, 30001, 3), launch_plan(96, 512, 30001, 3)
        assert (flag["tiles"], flag["grid"], flag["warpgroups"], flag["stages"]) == (130, 130, 3, 4)
        assert flag["smem_bytes"] == 218872 and flag["partial_floats"] * 4 == 798720
        assert (cli["warpgroups"], cli["passes"], cli["stages"]) == (2, 1, 4)
        assert launch_plan(257, 512, 30001, 3)["passes"] == 2
        assert launch_plan(192, 512, 40009, 3)["grid"] == 132      # blocks stride over 173

    @pytest.mark.parametrize("tv", [260, 228, 0])
    def test_a_tile_wgmma_cannot_take_is_refused(self, tv):
        with pytest.raises(ValueError, match="multiples of 8 up to 256"):
            launch_plan(192, 512, 30001, 3, tv=tv)


def _tile_partials_then_merge(h, w, b, k, suppress, tv=BF16_TILE):
    """The bf16 route's algorithm at float32, in numpy: per 232-column tile
    and row a (max, sum of exp) of the pre-suppression logits and a top-k of
    the suppressed ones (ties to the lower column), then the merge over
    tiles: lse = M + log(sum s_t exp(m_t - M)), top-k by (value desc, index
    asc)."""
    logits = h @ w.T + b
    n, v = logits.shape
    ms, ss, vals, idxs = [], [], [], []
    for t0 in range(0, v, tv):
        x = logits[:, t0:t0 + tv]
        m = x.max(1)
        ms.append(m)
        ss.append(np.exp(x - m[:, None]).sum(1))
        xs = x.copy()
        for sid in suppress:
            if t0 <= sid < t0 + tv:
                xs[:, sid - t0] += np.float32(-1000.0)
        order = np.argsort(-xs, axis=1, kind="stable")[:, :k]
        vals.append(np.take_along_axis(xs, order, 1))
        idxs.append(order + t0)
    m, s = np.stack(ms, 1), np.stack(ss, 1)
    big = m.max(1)
    lse = big + np.log((s * np.exp(m - big[:, None])).sum(1))
    cv, ci = np.concatenate(vals, 1), np.concatenate(idxs, 1)
    out_v, out_i = np.empty((n, k), np.float32), np.empty((n, k), np.int64)
    for r in range(n):
        order = np.lexsort((ci[r], -cv[r]))[:k]
        out_v[r], out_i[r] = cv[r, order], ci[r, order]
    return out_v, out_i, lse.astype(np.float32)


class TestTilePartialsThenMerge:
    """The kernel's tile-partials-then-merge algorithm at 232-column tiles,
    emulated at float32, == fused_logit_topk_plain and == the TPU kernel
    (interpret): identical indices, values 1e-6, lse rtol 2e-6."""

    @pytest.mark.parametrize("vocab", [130, 465, 1003])
    @pytest.mark.parametrize("suppress", [(), (231, 232), (0, 7, 231, 464)])
    def test_matches_plain_and_pallas_interpret(self, rng, vocab, suppress):
        n, d, k = 10, 32, 3
        suppress = tuple(s for s in suppress if s < vocab)
        h = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=(vocab, d)).astype(np.float32)
        for sid in suppress:
            w[sid] *= 10.0   # a suppressed column is a real contender
        b = (rng.normal(size=(vocab,)) * 0.1).astype(np.float32)
        ev, ei, elv = _tile_partials_then_merge(h, w, b, k, suppress)
        tv, ti, tlse = fused_logit_topk_plain(*map(torch.as_tensor, (h, w, b)), k, suppress)
        jv, ji, jlse = map(np.asarray, j_fused(jnp.asarray(h), jnp.asarray(w.T.copy()),
                                               jnp.asarray(b), k, suppress_ids=suppress,
                                               tile=128, interpret=True))
        for iv, vv, lv in ((ti.numpy(), tv.numpy(), tlse.numpy()), (ji, jv, jlse)):
            np.testing.assert_array_equal(ei, iv)
            np.testing.assert_allclose(ev, vv, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(elv, lv, rtol=2e-6)
        assert not np.isin(ei, suppress).any()

    @pytest.mark.parametrize("pair", [(231, 232), (463, 464)])
    def test_tie_across_a_tile_boundary_goes_to_the_lower_index(self, rng, pair):
        """Two equal columns on top, one on each side of a tile boundary."""
        n, d, k, vocab = 6, 32, 3, 700
        h = rng.normal(size=(n, d)).astype(np.float32)
        h[:, 0] = 8.0
        w = (rng.normal(size=(vocab, d)) * 0.1).astype(np.float32)
        w[list(pair)] = 0.0
        w[list(pair), 0] = 1.0
        b = np.zeros(vocab, np.float32)
        ev, ei, elv = _tile_partials_then_merge(h, w, b, k, ())
        assert (ei[:, :2] == np.asarray(pair)).all()
        tv, ti, tlse = fused_logit_topk_plain(*map(torch.as_tensor, (h, w, b)), k)
        jv, ji, _ = map(np.asarray, j_fused(jnp.asarray(h), jnp.asarray(w.T.copy()),
                                            jnp.asarray(b), k, tile=128, interpret=True))
        np.testing.assert_array_equal(ei, ti.numpy())
        np.testing.assert_array_equal(ei, ji)
        np.testing.assert_allclose(ev, tv.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(elv, tlse.numpy(), rtol=2e-6)


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
