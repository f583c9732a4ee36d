"""The fusion-attention kernel's host side on the CPU: its launch plan
(ops/fusion_attention.launch_plan, which csrc/fusion_attention.cu takes as
given and checks against its own layout), the two bf16 terms that carry a
float32 probability into the tensor cores, and the kernel's order of work
(dk cut into chunks whose partial scores are summed, one online-softmax update
per exchange of 64 keys, p.v per chunk with p split into hi + lo against bf16
V) written in
PyTorch against the plain version and the TPU kernel in interpret mode. The
kernel itself is held against the plain version on the card in
tests/test_torch_port_cuda.py.

Tolerances: float32 2e-4 (test_torch_port_fusion_kernel.TOL: two softmaxes
that sum in different orders); the split probability 2^-16 relative (each of
the two roundings keeps 8 bits); bf16 outputs 2e-2 (one bf16 ulp near 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evoke_tpu.ops.fusion_attention as jfa
from evoke_tpu_torch.ops import fusion_attention as tfa
from evoke_tpu_torch.ops.fusion_attention import (MAX_CLUSTER, SM_SMEM, SMEM_LIMIT,
                                                  cluster_order, launch_plan,
                                                  masked_cross_view_attention_plain,
                                                  split_probability)

from test_torch_port_fusion_kernel import TOL, _inputs, _masks

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layout_bytes(chunk, isz, tq, cluster):
    """csrc/fusion_attention.cu's Layout, region by region."""
    ldb = chunk * isz + 16
    q = min(64, tq) * ldb                          # rows past T are never loaded
    ring = 3 * 32 * ldb
    recv = cluster * -(-64 // cluster) * 64 * 4    # [C * rows a block owns][64 keys]
    p = 64 * (64 + 8) * 4
    assert p == 2 * 64 * (64 * 2 + 16)             # the hi and lo tiles fill p's room
    return q + ring + recv + p + 4 * 64 * 4 + 256 * 4 + 64 + 16


class TestFusionLaunchPlan:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("dk", [16, 96, 256, 264, 2048, 2304])
    @pytest.mark.parametrize("tq", [5, 50, 64, 65, 70, 130])
    def test_plan_fits_the_card(self, dtype, dk, tq):
        p = launch_plan(tq, dk, DTYPES[dtype])
        isz = 4 if dtype == "float32" else 2
        assert p["smem_bytes"] <= SMEM_LIMIT == 232448
        assert 1 <= p["cluster"] <= MAX_CLUSTER == 8
        assert p["row_tiles"] == -(-tq // 64) and p["threads"] == 32 * p["warps"] <= 1024
        blocks_x, blocks_z = p["grid_per_anchor"]
        assert blocks_z <= 65535 and blocks_x == p["cluster"]
        if dk > 8 * 256:                      # above 8 chunks: the first design's kernel
            assert p["route"] == "recompute" and p["cluster"] == 1 and p["stages"] == 1
            assert blocks_z == -(-dk // 256) * p["row_tiles"]
            assert p["smem_bytes"] == tfa.recompute_smem_bytes(DTYPES[dtype])
            return
        assert p["route"] == "cluster" and p["stages"] == 3
        assert p["chunk"] == (128 if dk <= 8 * 128 else 256)       # the narrowest that covers dk
        assert p["cluster"] == -(-dk // p["chunk"]) and blocks_z == p["row_tiles"]
        assert p["rows_per_block"] * p["cluster"] >= 64            # every row has an owner
        assert p["rows_per_block"] * (p["cluster"] - 1) < 64       # and every block owns rows
        assert p["cluster"] * p["rows_per_block"] <= 72            # the strips' room
        assert (p["key_tile"], p["group_keys"], p["warps"]) == (32, 64, 8)
        assert p["chunk"] // p["warps"] % 16 == 0
        assert p["smem_bytes"] == _layout_bytes(p["chunk"], isz, tq, p["cluster"])
        compiled_for = 2 if dtype == "bfloat16" else 1
        assert p["blocks_per_sm"] == min(compiled_for, SM_SMEM // (p["smem_bytes"] + 1024)) >= 1

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("dk", [16, 96, 264, 2048])
    def test_unaligned_rows_take_the_scalar_load_route(self, dtype, dk):
        p = launch_plan(50, dk, DTYPES[dtype], aligned=False)
        assert p["route"] == "recompute" and p["chunk"] == 256 and p["threads"] == 256
        assert p["smem_bytes"] == {"float32": 116992, "bfloat16": 102144}[dtype] <= SMEM_LIMIT

    def test_serving_shape(self):
        """T 50, dk 2048, bf16: 8 blocks of 256 columns, 32-key tiles, one
        exchange per 64 keys, and two blocks to an SM (so 33 clusters fit the
        card's 132 SMs by shared memory); from T 54 on q's slice takes more
        room than two blocks leave."""
        p = launch_plan(50, 2048, torch.bfloat16)
        assert (p["route"], p["chunk"], p["cluster"], p["key_tile"], p["warps"]) == (
            "cluster", 256, 8, 32, 8)
        assert p["smem_bytes"] == 114032 and p["blocks_per_sm"] == 2
        assert p["rows_per_block"] == 8 and p["grid_per_anchor"] == (8, 1)
        assert launch_plan(53, 2048, torch.bfloat16)["blocks_per_sm"] == 2
        assert launch_plan(54, 2048, torch.bfloat16)["blocks_per_sm"] == 1
        f = launch_plan(50, 2048, torch.float32)
        assert (f["chunk"], f["cluster"], f["key_tile"], f["blocks_per_sm"]) == (256, 8, 32, 1)
        assert f["smem_bytes"] == 188784

    @pytest.mark.parametrize("bad", [
        dict(tq=0), dict(dk=0), dict(dtype=torch.float16), dict(tq=64 * 65536, dk=2304),
        dict(tq=64 * 65536, aligned=False)])
    def test_what_the_kernel_does_not_take_is_refused(self, bad):
        args = dict(tq=50, dk=2048, dtype=torch.bfloat16)
        args.update(bad)
        with pytest.raises(ValueError):
            launch_plan(**args)

    def test_wrapper_plan_is_cached_per_shape(self):
        tfa._plan.cache_clear()
        a = tfa._plan(50, 2048, torch.bfloat16, True)
        assert a == (1, 256, 8, 32, 8, 114032) and tfa._plan(50, 2048, torch.bfloat16, True) is a
        assert tfa._plan(50, 2048, torch.bfloat16, False)[0] == 0      # the recompute route
        assert tfa._plan.cache_info().hits == 1

    def test_alignment_is_read_from_the_tensors(self):
        x = torch.zeros(3, 5, 2 * 24, dtype=torch.bfloat16)
        q = x.reshape(3, 5, 2, 24).transpose(1, 2)
        k = torch.zeros(2, 15, 24, dtype=torch.bfloat16)
        assert tfa._aligned(q, k, k)
        assert not tfa._aligned(q[..., :20], k[..., :20], k[..., :20])     # dk 20: 40-byte rows
        odd = torch.zeros(2 * 15 * 24 + 1, dtype=torch.bfloat16)[1:].view(2, 15, 24)
        assert not tfa._aligned(q, odd, k)                                  # base off by 2 bytes
        narrow = torch.zeros(2, 15, 28, dtype=torch.bfloat16)[..., :24]     # row stride 56 bytes
        assert not tfa._aligned(q, narrow, k)


def _cases():
    """The three masks of test_torch_port_fusion_kernel and one anchor that
    attends all B samples beside one that attends only the last."""
    every = np.zeros((3, 5), bool)
    every[0] = True
    every[1, 4] = True
    every[2, 1] = every[2, 2] = True
    return [m[:5] for m in _masks()] + [("attends_all", every, 7, 2, 24)]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


class TestClusterOrder:
    @pytest.mark.parametrize("chunk,key_tile", [(8, 3), (16, 32), (5, 4)])
    @pytest.mark.parametrize("name,attend,t,h,dk", _cases(), ids=[c[0] for c in _cases()])
    def test_float32_matches_plain_and_jax_kernel(self, rng, name, attend, t, h, dk, chunk,
                                                  key_tile):
        q, k, v = _inputs(rng, attend.shape[0], attend.shape[1], t, h, dk)
        tq, tk, tv, ta = (torch.as_tensor(x) for x in (q, k, v, attend))
        got = cluster_order(tq, tk, tv, ta, t, chunk=chunk, key_tile=key_tile)
        assert got.dtype == torch.float32 and got.shape == q.shape
        plain = masked_cross_view_attention_plain(tq, tk, tv, ta, t)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
        want = jfa.masked_cross_view_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               jnp.asarray(attend), t_tokens=t, key_block=16,
                                               interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    @pytest.mark.parametrize("name,attend,t,h,dk", _cases(), ids=[c[0] for c in _cases()])
    def test_bf16_split_matches_plain(self, rng, name, attend, t, h, dk):
        """bf16 inputs: p enters p.v as hi + lo against bf16 V, float32 sums."""
        q, k, v = (torch.as_tensor(x).bfloat16()
                   for x in _inputs(rng, attend.shape[0], attend.shape[1], t, h, dk))
        ta = torch.as_tensor(attend)
        got = cluster_order(q, k, v, ta, t, chunk=8, key_tile=4)
        assert got.dtype == torch.bfloat16
        plain = masked_cross_view_attention_plain(q, k, v, ta, t)
        torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2, atol=2e-2)

    @pytest.mark.parametrize("name,attend,t,h,dk", _cases(), ids=[c[0] for c in _cases()])
    def test_split_costs_less_than_2_to_minus_16(self, rng, name, attend, t, h, dk):
        """The same order of work with p whole against with p split: the
        float32 results before the output's rounding differ by at most 2^-16
        of sum |p| |v| / l <= max |v|."""
        q, k, v = (torch.as_tensor(x).bfloat16().float()      # bf16 values, float32 arithmetic
                   for x in _inputs(rng, attend.shape[0], attend.shape[1], t, h, dk))
        ta = torch.as_tensor(attend)
        whole = cluster_order(q, k, v, ta, t, chunk=8, key_tile=4, split=False)
        split = cluster_order(q, k, v, ta, t, chunk=8, key_tile=4, split=True)
        bound = 2.0 ** -16 * float(v.abs().max())
        err = float((whole - split).abs().max())
        assert 0 < err <= bound, (err, bound)

    def test_split_probability_bound(self, rng):
        p = torch.as_tensor(np.concatenate([
            rng.uniform(0, 1, 4096), np.exp(-rng.uniform(0, 80, 4096)), [0.0, 1.0]])
            .astype(np.float32))
        hi, lo = split_probability(p)
        assert hi.dtype == lo.dtype == torch.bfloat16
        err = (hi.double() + lo.double() - p.double()).abs()
        assert bool((err <= 2.0 ** -16 * p.double()).all())
        one = (hi.double() - p.double()).abs()                # one term alone: 2^-9
        assert float((one / p.double().clamp_min(1e-300)).max()) > 2.0 ** -10
