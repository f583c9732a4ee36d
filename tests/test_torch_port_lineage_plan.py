"""The lineage kernel's host side on the CPU: its launch plan
(ops/lineage_attention.launch_plan, which csrc/lineage_attention.cu takes as
given), the compact row list's content (attended_rows) against the lineage
masks, and the kernel's order of work (compact list, flags, scores over the
list, two-pass softmax, P.V) written in PyTorch against the plain version and
the TPU kernel in interpret mode. The kernel itself is held against the plain
version on the card in tests/test_torch_port_cuda.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.ops.lineage_attention import lineage_attention as j_lineage
from evoke_tpu_torch.ops.lineage_attention import (NEG_INF, SM_SMEM, SMEM_LIMIT, STATIC_SMEM,
                                                   attended_rows, launch_plan,
                                                   lineage_attention_plain, lineage_masks)

torch.set_num_threads(1)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SCHEDULE = (13, 25, 38, 50, 63, 75, 88, 100)      # the serving cache lengths


def _parent_admits(kbeam, lmax, dh):
    """The first design's shared-memory rule: kbeam^2 * L float32 scores and
    kbeam * L mask bytes beside its static arrays (q [4][dh] and the P.V
    partials [256 / dh][4][dh], float32) within a block's 227 KB."""
    static = 4 * dh * 4 + (256 // dh) * 4 * dh * 4
    return kbeam * kbeam * lmax * 4 + kbeam * lmax + static <= SMEM_LIMIT


def _parent_max_len(kbeam, dh):
    static = 4 * dh * 4 + (256 // dh) * 4 * dh * 4
    return (SMEM_LIMIT - static) // (kbeam * (4 * kbeam + 1))


class TestLineageLaunchPlan:
    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("dh", [32, 64, 128])
    @pytest.mark.parametrize("kbeam", [1, 2, 3, 4])
    @pytest.mark.parametrize("lmax", [1, *SCHEDULE, 257, 1024])
    def test_plan_fits_the_card(self, dtype, dh, kbeam, lmax):
        assert _parent_admits(kbeam, lmax, dh)
        p = launch_plan(kbeam, lmax, dh, DTYPES[dtype])
        isz = 4 if dtype == "float32" else 2
        rows = kbeam * lmax
        assert p["lanes_per_row"] * 16 == dh * isz            # 16 bytes a lane, one slice
        assert p["lanes_per_row"] * p["rows_per_load"] == 32
        assert p["rows_in_flight"] == p["loads_in_flight"] * p["rows_per_load"]
        # 4 loads a lane, but 2 where q alone fills half the 64 registers
        assert p["loads_in_flight"] == (2 if (dtype, kbeam) == ("bfloat16", 4) else 4)
        assert p["threads"] == 256 and p["warps"] == 8
        assert p["compact"] and p["list_bytes"] >= rows * 4
        assert p["score_bytes"] >= kbeam * rows * 4
        assert p["part_bytes"] == 8 * kbeam * dh * 4
        assert 0 <= p["v_rows"] <= rows and p["v_bytes"] == p["v_rows"] * dh * isz
        for key in ("v_bytes", "score_bytes", "list_bytes", "part_bytes"):
            assert p[key] % 16 == 0                            # 16-byte aligned regions
        assert p["smem_bytes"] == (p["v_bytes"] + p["score_bytes"] + p["list_bytes"]
                                   + p["part_bytes"])
        assert p["smem_bytes"] + STATIC_SMEM <= SMEM_LIMIT == 232448
        # a short tile only where one more row would not fit
        if p["v_rows"] < rows:
            assert p["smem_bytes"] + STATIC_SMEM + dh * isz > SMEM_LIMIT
        assert 1 <= p["blocks_per_sm"] <= 8
        assert p["blocks_per_sm"] * (p["smem_bytes"] + STATIC_SMEM + 1024) <= SM_SMEM

    @pytest.mark.parametrize("lmax", SCHEDULE)
    def test_serving_shape_runs_in_one_wave(self, lmax):
        """Beam 3, dh 64, bf16 at every cache length of the schedule: the
        whole V tile in shared memory and >= 4 blocks per SM, so 64 samples x
        8 heads = 512 blocks fit the 132 SMs at once."""
        p = launch_plan(3, lmax, 64, torch.bfloat16)
        assert p["v_rows"] == 3 * lmax and p["lanes_per_row"] == 8
        assert p["rows_in_flight"] == 16
        assert p["blocks_per_sm"] >= 4 and p["blocks_per_sm"] * 132 >= 512

    def test_serving_shape_bytes(self):
        p = launch_plan(3, 100, 64, torch.bfloat16)
        assert (p["v_bytes"], p["score_bytes"], p["list_bytes"], p["part_bytes"]) == (
            38400, 3600, 1200, 6144)
        assert p["smem_bytes"] == 49344 and p["loads_in_flight"] == 4
        # the float32 reference check runs the same shape: the tile still fits
        assert launch_plan(3, 100, 64, torch.float32)["v_rows"] == 300

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    @pytest.mark.parametrize("dh", [32, 64, 128])
    @pytest.mark.parametrize("kbeam", [1, 2, 3, 4])
    def test_every_length_the_first_design_took_gets_a_plan(self, dtype, dh, kbeam):
        """Up to the longest cache the first design's rule admits: a short V
        tile first, then (past ~11,000 rows) no list and no tile at all."""
        longest = _parent_max_len(kbeam, dh)
        assert _parent_admits(kbeam, longest, dh) and not _parent_admits(kbeam, longest + 1, dh)
        seen = set()
        for lmax in sorted({longest, longest // 2, longest // 4, 2048, 600, 110}):
            p = launch_plan(kbeam, lmax, dh, DTYPES[dtype])
            assert p["smem_bytes"] + STATIC_SMEM <= SMEM_LIMIT
            assert p["compact"] or (p["v_rows"] == 0 and p["list_bytes"] == 0)
            seen.add((p["compact"], p["v_rows"] == kbeam * lmax))
        assert (False, False) in seen          # the longest: rows walked in place
        assert (True, False) in seen           # a short tile

    @pytest.mark.parametrize("bad", [dict(kbeam=5), dict(kbeam=0), dict(lmax=0), dict(dh=48),
                                     dict(dtype=torch.float16), dict(lmax=60000, kbeam=4)])
    def test_what_the_kernel_does_not_take_is_refused(self, bad):
        args = dict(kbeam=3, lmax=100, dh=64, dtype=torch.bfloat16)
        args.update(bad)
        with pytest.raises(ValueError):
            launch_plan(**args)


def _inputs(seed, b, kbeam, lmax, d, lineage="random"):
    rng = np.random.default_rng(seed)
    n = b * kbeam
    anc = rng.integers(0, kbeam, size=(b, kbeam, lmax)).astype(np.int32)
    if lineage == "converged":      # one shared ancestor row for all but the last 5 slots
        anc[:, :, :max(lmax - 5, 0)] = rng.integers(0, kbeam, size=(b, 1, 1))
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32),
            rng.normal(size=(n, lmax, d)).astype(np.float32), anc)


def _age(seed, b, lmax):
    return np.random.default_rng(seed + 1).integers(0, lmax, size=b).astype(np.int32)


class TestAttendedRows:
    """attended_rows == the lineage masks' union over the queries."""

    @pytest.mark.parametrize("kbeam", [1, 2, 3, 4])
    @pytest.mark.parametrize("lmax,pos", [(1, 0), (12, 0), (12, 5), (12, 11), (100, 99)])
    @pytest.mark.parametrize("ring", [False, True])
    def test_equals_the_masks_union(self, kbeam, lmax, pos, ring):
        _, _, _, anc = _inputs(kbeam * 1000 + lmax + pos, 5, kbeam, lmax, 8)
        anc = torch.as_tensor(anc)
        age = torch.as_tensor(_age(pos, 5, lmax)) if ring else None
        got = attended_rows(anc, pos, age)
        want = lineage_masks(anc, pos, age)[:, 0].any(dim=1)
        assert got.dtype == torch.bool and got.shape == (5, kbeam * lmax)
        assert torch.equal(got, want)
        assert got.reshape(5, kbeam, lmax)[:, :, pos].all()     # each query's own row

    def test_converged_lineages_attend_one_row_per_old_slot(self):
        _, _, _, anc = _inputs(3, 4, 3, 100, 8, lineage="converged")
        need = attended_rows(torch.as_tensor(anc), 99).reshape(4, 3, 100)
        assert (need[:, :, :95].sum(1) == 1).all() and need[:, :, 99].all()
        random = attended_rows(torch.as_tensor(_inputs(3, 4, 3, 100, 8)[3]), 99)
        assert need.sum() < 0.6 * random.sum()


def _compact_then_attend(q, ck, cv, anc, pos, heads, age=None):
    """The kernel's order of work, one sample at a time: the ascending list of
    attended rows; per (query, row) a flag (0 attended, -1e9 masked) replaced
    by the scaled float32 score where it is 0; a two-pass softmax over the
    list, normalised before the rounding to V's dtype; P.V in float32."""
    b, kbeam, lmax = anc.shape
    d = q.shape[1]
    dh = d // heads
    need = attended_rows(anc, pos, age)
    mask = lineage_masks(anc, pos, age)[:, 0]                      # [B, q, kL]
    out = torch.empty_like(q)
    for s in range(b):
        rows = need[s].nonzero()[:, 0]
        assert (rows[1:] > rows[:-1]).all()
        sl = slice(s * kbeam, (s + 1) * kbeam)
        k = ck[sl].reshape(kbeam * lmax, heads, dh)[rows].float()
        v = cv[sl].reshape(kbeam * lmax, heads, dh)[rows]
        flags = torch.where(mask[s][:, rows], 0.0, NEG_INF)        # [q, n]
        sc = torch.einsum("qhd,nhd->hqn", q[sl].reshape(kbeam, heads, dh).float(), k)
        sc = torch.where(flags[None] == 0, sc * (1.0 / math.sqrt(dh)), flags[None])
        e = torch.exp(sc - sc.max(-1, keepdim=True).values)
        p = (e / e.sum(-1, keepdim=True)).to(v.dtype).float()
        out[sl] = torch.einsum("hqn,nhd->qhd", p, v.float()).reshape(kbeam, d).to(q.dtype)
    return out


class TestCompactThenAttend:
    """The kernel's algorithm in PyTorch == the plain version (float32 1e-5:
    summation order; bf16 one ulp of the output, 2^-7 relative with 2^-8
    absolute) == the TPU kernel in interpret mode (float32 2e-5)."""

    @pytest.mark.parametrize("kbeam", [1, 2, 3, 4])
    @pytest.mark.parametrize("mode", ["batch0", "batch_mid", "batch_last", "ring"])
    @pytest.mark.parametrize("lineage", ["random", "converged"])
    def test_float32_matches_plain(self, kbeam, mode, lineage):
        b, lmax, d, heads = 3, 13, 64, 2
        q, ck, cv, anc = map(torch.as_tensor, _inputs(7 + kbeam, b, kbeam, lmax, d, lineage))
        pos = dict(batch0=0, batch_mid=6, batch_last=12, ring=4)[mode]
        age = torch.as_tensor(np.array([0, 12, 7], np.int32)) if mode == "ring" else None
        got = _compact_then_attend(q, ck, cv, anc, pos, heads, age)
        want = lineage_attention_plain(q, ck, cv, anc, pos, heads, age=age)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("ring", [False, True])
    def test_bf16_matches_plain(self, ring):
        b, kbeam, lmax, d, heads, pos = 3, 3, 25, 64, 2, 20
        q, ck, cv, anc = map(torch.as_tensor, _inputs(11, b, kbeam, lmax, d))
        q, ck, cv = (x.to(torch.bfloat16) for x in (q, ck, cv))
        age = torch.as_tensor(np.array([3, 24, 0], np.int32)) if ring else None
        got = _compact_then_attend(q, ck, cv, anc, pos, heads, age)
        want = lineage_attention_plain(q, ck, cv, anc, pos, heads, age=age)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -8)

    @pytest.mark.parametrize("ring", [False, True])
    def test_float32_matches_pallas_interpret(self, ring):
        b, kbeam, lmax, d, heads, pos = 4, 3, 12, 64, 8, 7
        q, ck, cv, anc = _inputs(5, b, kbeam, lmax, d)
        age = np.array([0, 2, 5, 11], np.int32) if ring else None
        want = j_lineage(q, ck, cv, anc, pos, heads, interpret=True,
                         age=None if age is None else jnp.asarray(age))
        got = _compact_then_attend(*map(torch.as_tensor, (q, ck, cv, anc)), pos, heads,
                                   None if age is None else torch.as_tensor(age))
        np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=2e-5, atol=2e-5)
