"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs CUDA and skips without it (decided inside the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on the H100's machine, where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 1e-5 (summation order); bf16 outputs 2e-2 (one bf16 ulp
near 1), rtol and atol both. The fused top-k: lse 1e-5 (rtol and atol); float32 values 1e-4
with identical indices; bf16 values one ulp (rtol 2^-7: the float32 sums run
in another order, so a product may round to the neighbouring bf16 value),
indices equal wherever the values differ by more than that. The fusion
attention at float32 2e-5 (its scores sum over dk 2048 in another order)."""

import math

import numpy as np
import pytest
import torch

from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk, fused_logit_topk_plain
from evoke_tpu_torch.ops.fusion_attention import _aligned as fusion_aligned
from evoke_tpu_torch.ops.fusion_attention import launch_plan as launch_plan_k3
from evoke_tpu_torch.ops.fusion_attention import (masked_cross_view_attention,
                                                  masked_cross_view_attention_plain)
from evoke_tpu_torch.ops.lineage_attention import (launch_plan, lineage_attention,
                                                   lineage_attention_plain)


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


def _lineage_case(dev, dtype, b, kbeam, lmax, d, lineage, seed):
    """q, caches and anc on the card from numpy. ``lineage``: "random";
    "converged" (all queries share one ancestor row in every slot but the last
    5, as a real beam does); "dead" (no lineage ever passes through the last
    beam row, so its history is never read)."""
    rng = np.random.default_rng(seed)
    q, ck, cv, anc = _lineage_inputs(rng, b, kbeam, lmax, d)
    if lineage == "converged":
        anc[:, :, :max(lmax - 5, 0)] = rng.integers(0, kbeam, size=(b, 1, 1))
    elif lineage == "dead":
        anc = rng.integers(0, max(kbeam - 1, 1), size=anc.shape).astype(np.int32)
    t = lambda x: torch.as_tensor(x).to(dev)
    return t(q).to(dtype), t(ck).to(dtype), t(cv).to(dtype), t(anc)


def _lineage_modes(dev, b, lmax):
    """(pos, age): batch mode at pos 0, mid and L - 1; ring mode with every
    age 0, every age L - 1, and a window that wraps past slot 0."""
    mid = lmax // 2
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
    wrapped = torch.as_tensor((np.arange(b) % lmax).astype(np.int32)).to(dev)
    return [(0, None), (mid, None), (lmax - 1, None), (mid, full(0)), (mid, full(lmax - 1)),
            (min(2, lmax - 1), wrapped)]


def _assert_lineage_close(args, pos, heads, age, dtype):
    got = lineage_attention(*args, pos, heads, age=age)
    want = lineage_attention_plain(*args, pos, heads, age=age)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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


def _fusion_inputs(dev, dtype, qn, b, t, h, dk, seed):
    """q [Q, h, T, dk] and k, v [h, B * T, dk] as strided views of projection
    outputs [*, T, h * dk], as the fusion module passes them; from numpy."""
    rng = np.random.default_rng(seed)
    x = lambda n: torch.as_tensor(rng.normal(size=(n, t, h * dk)).astype(np.float32)
                                  ).to(dev).to(dtype)
    return (x(qn).reshape(qn, t, h, dk).transpose(1, 2),
            x(b).reshape(b * t, h, dk).transpose(0, 1),
            x(b).reshape(b * t, h, dk).transpose(0, 1))


def _assert_fusion_close(got, q, k, v, attend, t):
    want = masked_cross_view_attention_plain(q, k, v, attend, t)
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
    @pytest.mark.parametrize("kbeam", [1, 2, 3, 4])
    @pytest.mark.parametrize("dh", [32, 64, 128])
    @pytest.mark.parametrize("lmax", [1, 13, 100, 257])
    def test_lineage_kernel_grid(self, cuda_device, dtype, kbeam, dh, lmax):
        """Every instantiation at four cache lengths, each in six modes (batch
        at pos 0 / mid / L - 1, ring with age 0 / L - 1 / a wrapped window)
        and three lineages (random, converged, one beam dead everywhere).
        L 257 at float32 or dh 128 has a V tile shorter than the row list."""
        b, heads = 5, 2
        for lineage in ("random", "converged", "dead"):
            args = _lineage_case(cuda_device, dtype, b, kbeam, lmax, heads * dh, lineage,
                                 seed=kbeam * 1000 + dh + lmax)
            for pos, age in _lineage_modes(cuda_device, b, lmax):
                _assert_lineage_close(args, pos, heads, age, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("b", [1, 257])
    def test_lineage_kernel_sample_counts(self, cuda_device, dtype, b):
        args = _lineage_case(cuda_device, dtype, b, 3, 100, 512, "random", seed=b)
        age = torch.as_tensor((np.arange(b) * 7 % 100).astype(np.int32)).to(cuda_device)
        n0 = lineage_attention.launches
        _assert_lineage_close(args, 99, 8, None, dtype)
        _assert_lineage_close(args, 41, 8, age, dtype)
        assert lineage_attention.launches == n0 + 2

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kbeam,lmax", [(1, 30000), (4, 3000), (3, 1024)])
    def test_lineage_kernel_long_caches(self, cuda_device, dtype, kbeam, lmax):
        """Lengths the first design took: past ~11,000 rows the plan has no
        row list (rows walked in place); at 3 x 1024 the V tile is shorter
        than the list."""
        p = launch_plan(kbeam, lmax, 32, dtype)
        assert p["compact"] == (lmax == 1024) and p["v_rows"] < kbeam * lmax
        for lineage in ("random", "converged"):
            args = _lineage_case(cuda_device, dtype, 2, kbeam, lmax, 64, lineage, seed=lmax)
            age = torch.as_tensor(np.array([lmax - 1, 17], np.int32)).to(cuda_device)
            _assert_lineage_close(args, lmax - 1, 2, None, dtype)
            _assert_lineage_close(args, 5, 2, age, dtype)

    def test_lineage_kernel_refuses_what_it_cannot_read(self, cuda_device):
        q, ck, cv, anc = _lineage_case(cuda_device, torch.bfloat16, 4, 3, 13, 512, "random", 0)
        wide = torch.zeros(12, 13, 1024, dtype=torch.bfloat16, device=cuda_device)
        n0 = lineage_attention.launches
        with pytest.raises(ValueError, match="contiguous"):
            lineage_attention(q, wide[:, :, :512], cv, anc, 9, 8)
        with pytest.raises(ValueError, match="contiguous"):
            lineage_attention(torch.zeros(12, 1024, dtype=torch.bfloat16,
                                          device=cuda_device)[:, ::2], ck, cv, anc, 9, 8)
        with pytest.raises(ValueError, match="16-byte aligned"):
            lineage_attention(torch.zeros(12 * 512 + 1, dtype=torch.bfloat16,
                                          device=cuda_device)[1:].view(12, 512), ck, cv, anc, 9, 8)
        with pytest.raises(ValueError, match="outside the cache's slots"):
            lineage_attention(q, ck, cv, anc, 13, 8)
        with pytest.raises(TypeError):
            lineage_attention(q, ck, cv, anc.long(), 9, 8)
        assert lineage_attention.launches == n0

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
    @pytest.mark.parametrize("t", [5, 50, 64, 65, 70, 130])
    @pytest.mark.parametrize("dk", [16, 96, 264, 2048, 2304])
    def test_fusion_attention_kernel(self, cuda_device, dtype, t, dk):
        """T below, at and above one 64-row tile (and above two), so samples of
        one key tile, a pair, a pair and one, and five; dk of one block, of 3
        blocks with a ragged last chunk, of a full cluster of 8,
        and above 8 chunks (the recompute route). Anchors attend 1 (the self
        slot), 2, 4 and all B samples, and one attends only the last sample.
        Strided views as the module passes them, then contiguous copies: the
        same bits, and the same bits again on a second call (no atomics)."""
        q, k, v = _fusion_inputs(cuda_device, dtype, 5, 6, t, 2, dk, seed=t + dk)
        attend = np.zeros((5, 6), bool)
        attend[0, 0] = True
        attend[1, 1] = attend[1, 4] = True
        attend[2, [0, 2, 3, 5]] = True
        attend[3, 5] = True
        attend[4] = True
        attend = torch.as_tensor(attend).to(cuda_device)
        assert launch_plan_k3(t, dk, dtype)["route"] == ("recompute" if dk > 2048 else "cluster")
        n0 = masked_cross_view_attention.launches
        got = masked_cross_view_attention(q, k, v, attend, t)
        assert masked_cross_view_attention.launches == n0 + 1
        _assert_fusion_close(got, q, k, v, attend, t)
        assert torch.equal(got, masked_cross_view_attention(q, k, v, attend, t))
        assert torch.equal(got, masked_cross_view_attention(q.contiguous(), k.contiguous(),
                                                            v.contiguous(), attend, t))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("n_anchor", [32, 64])
    def test_fusion_attention_kernel_layouts(self, cuda_device, dtype, n_anchor):
        """The CLI layout (32 anchors, 64 images) and the flagship layout (64,
        128) at full width: T 50, 8 heads, dk 2048; anchor i has (0, 1, 3,
        0)[i % 4] partners, a partnerless anchor its self slot."""
        b = 2 * n_anchor
        partners = [(0, 1, 3, 0)[i % 4] for i in range(n_anchor)]
        attend = np.zeros((n_anchor, b), bool)
        aux = n_anchor
        for i, n in enumerate(partners):
            attend[i, aux:aux + n] = True
            attend[i, i] = n == 0
            aux += n
        attend = torch.as_tensor(attend).to(cuda_device)
        q, k, v = _fusion_inputs(cuda_device, dtype, n_anchor, b, 50, 8, 2048, seed=n_anchor)
        got = masked_cross_view_attention(q, k, v, attend, 50)
        _assert_fusion_close(got, q, k, v, attend, 50)
        assert torch.equal(got, masked_cross_view_attention(q, k, v, attend, 50))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("kind", ["dk_off_16_bytes", "base_off_16_bytes", "odd_row_stride"])
    def test_fusion_attention_kernel_unaligned_rows(self, cuda_device, dtype, kind):
        """Rows that do not start on 16-byte boundaries run on the card by the
        recompute route's scalar loads, never by the plain version."""
        qn, b, t, h = 3, 4, 50, 2
        dk = 100 if kind != "dk_off_16_bytes" or dtype == torch.bfloat16 else 102
        q, k, v = (x.contiguous() for x in _fusion_inputs(cuda_device, dtype, qn, b, t, h, dk, 1))
        if kind == "base_off_16_bytes":
            dk = 96
            flat = torch.zeros(k.numel() + 1, dtype=dtype, device=cuda_device)
            q, v = q[..., :96].contiguous(), v[..., :96].contiguous()
            k = flat[1:1 + h * b * t * 96].view(h, b * t, 96).copy_(k[..., :96])
        elif kind == "odd_row_stride":
            dk = 96
            q, k, v = q[..., :96], k[..., :96], v[..., 2:98]
        assert not fusion_aligned(q, k, v)
        attend = torch.as_tensor(np.eye(qn, b, dtype=bool) | np.eye(qn, b, 1, dtype=bool)
                                 ).to(cuda_device)
        n0 = masked_cross_view_attention.launches
        got = masked_cross_view_attention(q, k, v, attend, t)
        assert masked_cross_view_attention.launches == n0 + 1
        _assert_fusion_close(got, q, k, v, attend, t)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_fusion_attention_kernel_many_samples(self, cuda_device, dtype):
        """More samples than one pass of the block's sample list (256): an
        anchor that attends samples of two passes, one that attends all 300,
        one that attends only the last."""
        qn, b, t, h, dk = 3, 300, 5, 2, 256
        q, k, v = _fusion_inputs(cuda_device, dtype, qn, b, t, h, dk, seed=3)
        attend = np.zeros((qn, b), bool)
        attend[0, [0, 255, 256, 299]] = True
        attend[1] = True
        attend[2, 299] = True
        attend = torch.as_tensor(attend).to(cuda_device)
        got = masked_cross_view_attention(q, k, v, attend, t)
        _assert_fusion_close(got, q, k, v, attend, t)


# ---- the beam loop replayed from CUDA graphs against the same loop run eagerly ----

_LOOP_VOCAB, _LOOP_BATCH, _LOOP_BEAM = 30000, 64, 3
_LOOP_SCHEDULE = (8, 15, 30)
_LOOP_SWITCH = 9          # the EOS bias rises here: every beam finishes in phase [8, 15)
_LOOP_CONTRACTS = {
    "logp": dict(),
    "raw": dict(raw_logits=True, suppress_ids=(4,), decoding_constraint=True),
    "fused": dict(raw_logits=True, fused_topk=True, ancestor_kv=True),
}


def _loop_case(dev, dtype, contract, early_stop, seed=0):
    """(step, state0, keywords) of a BeamLoop over the R2Gen decoder at full
    width (d 512, 8 heads, 30001 logits, 64 samples x beam 3) and its full
    depth of 3 layers, seeded weights and inputs. With ``early_stop`` the step
    sets the EOS logit bias to -50 at step 0 and +50 at step ``_LOOP_SWITCH``."""
    from evoke_tpu_torch.models.rm_decoder import RMDecoder
    from evoke_tpu_torch.params import init_params_

    with torch.device(dev):
        dec = init_params_(RMDecoder(vocab_size=_LOOP_VOCAB, num_layers=3,
                                     max_seq_len=_LOOP_SCHEDULE[-1], dtype=dtype), 0).eval()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    att = torch.randn(_LOOP_BATCH, 49, 2048, generator=g, device=dev).to(dtype)
    mask = torch.ones(_LOOP_BATCH, 49, dtype=torch.int32, device=dev)
    eos = _LOOP_VOCAB - 1
    with torch.inference_mode():
        lo, hi = dec.logit.bias.clone(), dec.logit.bias.clone()
        lo[eos] -= 50.0
        hi[eos] += 50.0
        state0 = dec.init_decode_state(dec.encode(att, mask), _LOOP_BATCH * _LOOP_BEAM,
                                       _LOOP_SCHEDULE[0])
    kw = (dict(return_topk=_LOOP_BEAM, topk_suppress=(4,)) if contract == "fused"
          else dict(return_logits=contract == "raw"))

    def step(tok, t, st):
        if early_stop and t in (0, _LOOP_SWITCH):
            dec.logit.bias.copy_(hi if t else lo)
        return dec.decode_step(tok, t, st, mask, **kw)

    loop_kw = dict(bos_id=_LOOP_VOCAB - 2, eos_id=eos, pad_id=0, vocab_size=_LOOP_VOCAB + 1,
                   beam_size=_LOOP_BEAM, max_len=_LOOP_SCHEDULE[-1], length_penalty="wu_0.8",
                   cache_schedule=_LOOP_SCHEDULE, early_stop=early_stop,
                   **_LOOP_CONTRACTS[contract])
    return dec, step, state0, loop_kw


def _run_loop(step, state0, loop_kw, graphs):
    from evoke_tpu_torch.decode.beam import BeamLoop

    loop = BeamLoop(step, state0, _LOOP_BATCH, graphs=graphs, **loop_kw)
    loop.load(state0)
    res = loop.run()
    torch.cuda.synchronize()
    return loop, res


class TestBeamLoopGraphs:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("contract", sorted(_LOOP_CONTRACTS))
    @pytest.mark.parametrize("early_stop", [False, True])
    def test_captured_equals_eager(self, cuda_device, dtype, contract, early_stop):
        """Same kernels in the same order: tokens, scores and alive log-probs
        bit-equal; with early stop both leave at the end of the second phase."""
        _, step, state0, kw = _loop_case(cuda_device, dtype, contract, early_stop)
        cap, got = _run_loop(step, state0, kw, graphs=True)
        eag, want = _run_loop(step, state0, kw, graphs=False)
        assert cap.graphs and not eag.graphs and len(cap._graphs) == _LOOP_SCHEDULE[-1]
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        steps = _LOOP_SCHEDULE[1] if early_stop else _LOOP_SCHEDULE[-1]
        assert cap.steps_run == eag.steps_run == steps
        assert cap.flag_reads == eag.flag_reads == (2 if early_stop else 0)
        live = _LOOP_SWITCH + 1 if early_stop else _LOOP_SCHEDULE[-1]
        assert int(cap.live_steps) == int(eag.live_steps) == live
        if early_stop:
            assert (got.seqs == kw["eos_id"]).any(-1).all()
        assert got.seqs.unique().numel() > 3

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_second_batch_through_one_loop_equals_a_fresh_loop(self, cuda_device, dtype):
        dec, step, first, kw = _loop_case(cuda_device, dtype, "fused", False, seed=0)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(1)
        att = torch.randn(_LOOP_BATCH, 49, 2048, generator=g, device=cuda_device).to(dtype)
        mask = torch.ones(_LOOP_BATCH, 49, dtype=torch.int32, device=cuda_device)
        with torch.inference_mode():
            second = dec.init_decode_state(dec.encode(att, mask), _LOOP_BATCH * _LOOP_BEAM,
                                           _LOOP_SCHEDULE[0])
        loop, res1 = _run_loop(step, first, kw, graphs=True)
        loop.load(second)
        res2 = loop.run()
        _, fresh = _run_loop(step, second, kw, graphs=True)
        for a, b in zip(res2, fresh):
            assert torch.equal(a, b)
        assert not torch.equal(res1.seqs, res2.seqs)
        with pytest.raises(RuntimeError, match="load"):
            loop.run()

    def test_replays_count_as_launches(self, cuda_device):
        """3 decoder layers: K1 three times and K2 once per replayed step; the
        capture itself counts nothing."""
        from evoke_tpu_torch.decode.beam import BeamLoop

        _, step, state0, kw = _loop_case(cuda_device, torch.bfloat16, "fused", False)
        lineage_attention.launches = fused_logit_topk.launches = 0
        loop = BeamLoop(step, state0, _LOOP_BATCH, graphs=True, **kw)
        warm = len(_LOOP_SCHEDULE)             # one eager step per cache phase before capture
        assert (lineage_attention.launches, fused_logit_topk.launches) == (3 * warm, warm)
        lineage_attention.launches = fused_logit_topk.launches = 0
        loop.load(state0)
        loop.run()
        steps = _LOOP_SCHEDULE[-1]
        assert (lineage_attention.launches, fused_logit_topk.launches) == (3 * steps, steps)
        assert set(loop._ledger.per_graph.values()) == {(3, 1)}


class TestEvalPath:
    """The ``test`` task's pieces on the card: the CheXbert labeler and
    ``FinetuneTrainer.evaluate``."""

    def test_chexbert_labeler_card_equals_cpu(self, cuda_device):
        """BERT-base width (12 x 768, 12 heads, 3072, 30522 words), seeded
        weights, float32 with TF32 off: logits within 1e-4 (two devices sum
        12 layers of float32 products in other orders), labels equal."""
        from evoke_tpu_torch.evals.chexbert import ChexbertLabeler
        from evoke_tpu_torch.params import init_params_

        cpu = init_params_(ChexbertLabeler().eval(), 0)
        card = ChexbertLabeler().to(cuda_device).eval()
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(0)
        ids = rng.integers(1000, 30522, size=(4, 96)).astype(np.int32)
        ids[:, 0] = 101
        mask = np.ones_like(ids)
        mask[1, 60:] = 0
        ids[1, 60:] = 0
        with torch.inference_mode():
            want = torch.cat(cpu(torch.as_tensor(ids), torch.as_tensor(mask)), 1)
            got = torch.cat(card(torch.as_tensor(ids, device=cuda_device),
                                 torch.as_tensor(mask, device=cuda_device)), 1).cpu()
        assert (got - want).abs().max().item() <= 1e-4
        bounds = list(range(0, 53, 4)) + [54]
        for a, b in zip(bounds, bounds[1:]):
            assert torch.equal(got[:, a:b].argmax(1), want[:, a:b].argmax(1))

    def test_evaluate_captured_equals_eager(self, cuda_device, tmp_path):
        """The eval path's decode steps replayed from CUDA graphs write the same
        test_prediction.csv as the same steps run eagerly (float32, toy
        dimensions, NLG metrics)."""
        from evoke_tpu_torch import cli
        from evoke_tpu_torch.core.config import load_config
        from evoke_tpu_torch.data.datasets import load_annotation
        from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
        from evoke_tpu_torch.data.tokenizer import build_tokenizer
        from evoke_tpu_torch.params import init_params_
        from evoke_tpu_torch.train.trainer import Tester

        root = str(tmp_path)
        ann = write_synthetic_dataset(root, n_train=4, n_val=0, n_test=9, image_size=32, seed=2)
        argv = ["--data.ann_path", ann, "--data.image_dir", root, "--data.tokenizer_dir",
                f"{root}/tok", "--trainer.result_dir", f"{root}/res", "--data.batch_size", "4",
                "--data.max_seq_len", "24", "--model.image_size", "32",
                "--model.encoder_num_hidden_layers", "1", "--model.num_layers", "2"]
        out = {}
        for graphs in (None, False):
            cfg = load_config(None, overrides={"trainer.task": "test"},
                              argv=argv + ["--trainer.version", f"g{graphs}"])
            tok = build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name, ann_path=ann)
            cfg.vocab_size = tok.get_vocab_size()
            model = init_params_(cli.build_model(cfg, cfg.vocab_size, cuda_device), 0).eval()
            tester = Tester(cfg, model, tok, eval_loaders={
                "test": cli.build_loaders(cfg, tok, load_annotation(ann))},
                metrics_fn=cli.metrics_fn_for(cfg, cuda_device), device=cuda_device,
                graphs=graphs)
            tester.test()
            loops = [loop for g in (tester.gen_inc, tester.gen_noinc)
                     for loop, _ in g.loops.values()]
            assert loops and all(loop.graphs == (graphs is None) for loop in loops)
            with open(f"{cfg.result_dir}/test_prediction.csv") as f:
                out[graphs] = f.read()
        assert out[None] == out[False] and out[None].count("\n") == 1 + 7 + 9


# ---- the continuous engine replayed from CUDA graphs against the same engine run eagerly ----

_ENGINE_VOCAB, _ENGINE_SLOTS, _ENGINE_BEAM, _ENGINE_LEN = 30000, 16, 3, 100


def _engine_model(dev, dtype):
    """A FinetuneModel with a narrow encoder (64 px, 2 heads) and the R2Gen
    decoder at full width (d 512, 8 heads, 3 layers, 30001 logits), seeded."""
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.params import init_params_

    with torch.device(dev):
        model = FinetuneModel(vocab_size=_ENGINE_VOCAB, output_dim=256, encoder_hidden_size=64,
                              encoder_num_layers=1, encoder_num_heads=2,
                              encoder_intermediate_size=128, fusion_num_heads=2,
                              fusion_intermediate_size=128, proj_num_heads=2,
                              fusion_wide_qkv=False, max_seq_len=_ENGINE_LEN, dtype=dtype)
    return init_params_(model, 0).eval()


def _engine_loader(n_batches, width, seed=0):
    """Loader batches of ``width`` studies with an indication and one aux view
    each, 64 px, and forced report lengths in ``_aux`` (15..100)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        out.append({
            "images": rng.normal(size=(2 * width, 64, 64, 3)).astype(np.float32),
            "ids": np.ones((width, 16), np.int32), "mask": np.ones((width, 16), np.int32),
            "pids": np.concatenate([np.arange(width)] * 2).astype(np.int32),
            "valid": np.ones(2 * width, bool),
            "inc_ids": rng.integers(5, 1000, size=(width, 16)).astype(np.int32),
            "inc_mask": np.ones((width, 16), np.int32),
            "_image_ids": [f"s{seed}_{i}_{j}" for j in range(width)],
            "_aux": rng.integers(15, _ENGINE_LEN + 1, size=width).astype(np.int32)})
    return out


def _force_topk(eos):
    """The forced-length surface on the fused tail: each slot's target length
    is its ``aux``."""
    from evoke_tpu_torch.decode.forcing import force_topk

    def wrapper(vals, idx, lse, age_rows, aux):
        return force_topk(vals, idx, age_rows, aux.repeat_interleave(_ENGINE_BEAM), eos)

    return wrapper


def _engine(dev, dtype, graphs, **kw):
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.decode.forcing import synthetic_tokenizer

    tok = synthetic_tokenizer(_ENGINE_VOCAB, spell_ids=True)
    return ContinuousServer(_engine_model(dev, dtype), tok, max_seq_len=_ENGINE_LEN,
                            slots=_ENGINE_SLOTS, beam_size=_ENGINE_BEAM, suppress_unk=True,
                            topk_wrapper=_force_topk(tok.eos_id), device=dev, graphs=graphs,
                            **{"seg_steps": 10, "dispatch_segs": 2, "pack_batches": 2, **kw})


def _lengths_honoured(records, batches):
    want = {i: int(n) for b in batches for i, n in zip(b["_image_ids"], b["_aux"])}
    got = {r["id"]: len(r["report"].split()) for r in records}
    return got == want


class TestContinuousGraphs:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_captured_equals_eager(self, cuda_device, dtype):
        """The same dispatches on the card: the records, and every carry and
        decode-state buffer after the run, bit-equal; each study's forced
        length honoured."""
        batches = _engine_loader(4, 12)
        out = {}
        for graphs in (None, False):
            srv = _engine(cuda_device, dtype, graphs)
            recs, stats = srv.serve(batches)
            torch.cuda.synchronize()
            out[graphs] = (srv, recs, stats)
        (cap, rc, sc), (eag, re_, se) = out[None], out[False]
        assert cap.loop.graphs and not eag.loop.graphs and len(cap.loop._steps) == _ENGINE_LEN
        assert rc == re_ and _lengths_honoured(rc, batches)
        assert sc["segment_steps"] == se["segment_steps"] and sc["capture_s"] > 0
        for name in ("seq", "done_seq", "done_score", "alive", "age", "base", "tok", "t"):
            assert torch.equal(getattr(cap.loop, name), getattr(eag.loop, name)), name
        for key in ("memory", "cache_k", "cache_v", "anc"):
            for a, b in zip(cap.loop.dec[key] if key.startswith("cache") else [cap.loop.dec[key]],
                            eag.loop.dec[key] if key.startswith("cache") else [eag.loop.dec[key]]):
                assert torch.equal(a, b), key

    def test_pack_switch_with_dispatches_in_flight(self, cuda_device):
        """One loader batch a pack, so the host switches packs while ``depth``
        dispatches are queued: the records equal those of depth 1 (a read
        after every dispatch), at float32 (the studies land in other slots and
        ring offsets, which changes only the order of sums)."""
        from evoke_tpu_torch.decode import continuous

        batches = _engine_loader(5, 8, seed=1)
        srv = _engine(cuda_device, torch.float32, None, pack_batches=1, dispatch_segs=1)
        loads = []
        load = continuous.ContinuousLoop.load_pack

        def counted(self, pack):
            loads.append(pack["att_mask"].shape[0])
            return load(self, pack)

        continuous.ContinuousLoop.load_pack = counted
        try:
            deep, _ = srv.serve(batches, depth=4)
            n_deep = len(loads)
            shallow, _ = srv.serve(batches, depth=1)
        finally:
            continuous.ContinuousLoop.load_pack = load
        assert n_deep == len(batches) and deep == shallow
        assert _lengths_honoured(deep, batches)

    def test_second_serve_of_another_width_and_no_recapture(self, cuda_device):
        """A warm server: the same width captures nothing; another width
        captures only its segment heads; the records equal a fresh server's."""
        wide, narrow = _engine_loader(2, 12, seed=2), _engine_loader(3, 8, seed=2)
        srv = _engine(cuda_device, torch.bfloat16, None)
        first, s1 = srv.serve(wide)
        steps = list(srv.loop._steps)
        again, s2 = srv.serve(wide)
        second, s3 = srv.serve(narrow)
        fresh, _ = _engine(cuda_device, torch.bfloat16, None).serve(narrow)
        assert s1["capture_s"] > 0 and s2["capture_s"] == 0.0 and s3["capture_s"] > 0
        assert srv.loop._steps == steps and sorted(srv.loop._heads) == [16, 24]
        assert first == again and second == fresh
        assert _lengths_honoured(second, narrow)

    def test_replays_count_as_launches(self, cuda_device):
        """3 decoder layers: K1 three times and K2 once per replayed step; the
        segment heads launch neither; the capture counts nothing."""
        batches = _engine_loader(2, 12, seed=3)
        srv = _engine(cuda_device, torch.bfloat16, None)
        srv.serve(batches[:1])
        lineage_attention.launches = fused_logit_topk.launches = 0
        srv.loop.steps_run = 0
        srv.serve(batches)
        torch.cuda.synchronize()
        steps = srv.loop.steps_run
        assert steps > 0 and (lineage_attention.launches, fused_logit_topk.launches) == (
            3 * steps, steps)
        per = srv.loop._ledger.per_graph
        assert {per[key] for key in per if key[0] == "step"} == {(3, 1)}
        assert {per[key] for key in per if key[0] == "head"} == {(0, 0)}


# ---- finetune training on the card ----

# tests/_torch_port_util.TINY (that module imports JAX, absent on the card's machine)
TRAIN_TINY = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
                  encoder_num_heads=2, encoder_intermediate_size=64, d_model=32, d_ff=64,
                  num_heads=2, num_layers=2, rm_num_slots=3, rm_d_model=32,
                  fusion_num_heads=2, fusion_intermediate_size=64, sk_fusion_num_layers=1,
                  max_seq_len=16, fusion_wide_qkv=False)
TRAIN_LR = dict(pt_lr=1e-2, ft_lr=3e-2, weight_decay=1e-4, grad_clip_value=0.1)


def _train_batch(seed, n_anchor=2, image_size=64, seq=16, vocab=50):
    rng = np.random.default_rng(seed)
    total = 2 * n_anchor
    b = {"images": rng.normal(size=(total, image_size, image_size, 3)).astype(np.float32),
         "ids": rng.integers(5, vocab - 3, size=(n_anchor, seq)).astype(np.int32),
         "mask": np.ones((n_anchor, seq), np.int32),
         "pids": np.concatenate([np.arange(n_anchor), np.arange(n_anchor)]).astype(np.int32),
         "valid": np.ones(total, bool),
         "inc_ids": rng.integers(5, vocab - 3, size=(n_anchor, seq)).astype(np.int32),
         "inc_mask": np.ones((n_anchor, seq), np.int32)}
    b["mask"][-1, seq * 3 // 4:] = 0
    b["valid"][-1] = False
    b["images"][-1] = 0.0
    return b


def _tiny_train_model(seed=0, **kw):
    """The TINY flagship on the CPU, seeded, each Bottleneck's bn3 scale x 0.1
    (a well-conditioned batch-statistics forward at 4 images)."""
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.params import init_params_

    model = init_params_(FinetuneModel(vocab_size=50, **TRAIN_TINY, **kw), seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.mul_(0.1)
    return model


def _one_step(model, batch, dropout=False, opt_name="RAdam"):
    """(loss, the gradients the optimizer got, the updated parameters), on the CPU."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    opt = build_optimizer(opt_name, "finetune", model, **TRAIN_LR)
    seen, step = {}, opt.step
    opt.step = lambda g: seen.update({k: v.detach().float().cpu() for k, v in g.items()
                                      if v is not None}) or step(g)
    out = make_train_step(model, opt, 0, with_indication=True, dropout=dropout)(
        TrainState(model, opt), batch)
    return (float(out["lm"]), seen,
            {n: p.detach().float().cpu() for n, p in model.named_parameters()})


class TestTraining:
    """The finetune train step on the card. Card against CPU at float32, TF32
    off: the loss 1e-4 relative; gradients outside the ResNet 1e-3 of (the
    leaf's largest + 1e-3 of the largest gradient), the ResNet's 3e-2 in L2
    norm relative (33 batch-statistics BatchNorm blocks over 4 images amplify
    float32 rounding: the port's float32 step on one CPU is only that close to
    its float64 step); updated parameters within the learning rate times
    their gradient's difference plus 1e-6 relative."""

    def test_tiny_float32_step_card_equals_cpu(self, cuda_device):
        import copy

        model = _tiny_train_model()
        b = _train_batch(1)
        cpu = _one_step(copy.deepcopy(model), {k: torch.as_tensor(v) for k, v in b.items()})
        card = _one_step(copy.deepcopy(model).to(cuda_device),
                         {k: torch.as_tensor(v).to(cuda_device) for k, v in b.items()})
        assert math.isclose(card[0], cpu[0], rel_tol=1e-4)
        gmax = max(g.abs().max().item() for g in cpu[1].values())
        num = den = 0.0
        for n, want in cpu[1].items():
            got = card[1][n]
            if n.startswith("visual_extractor."):
                num += float(((got - want) ** 2).sum())
                den += float((want ** 2).sum())
                continue
            assert (got - want).abs().max() <= 1e-3 * (want.abs().max() + 1e-3 * gmax), n
        assert math.sqrt(num / den) <= 3e-2
        for n, want in cpu[2].items():
            lr = TRAIN_LR["ft_lr"] if any(s in n for s in (
                "text_decoder", "visual_self_atten", "multimodal_fusion", "visual_head",
                "text_head")) else TRAIN_LR["pt_lr"]
            zero = torch.zeros_like(want)
            g_err = (card[1].get(n, zero) - cpu[1].get(n, zero)).abs()
            assert ((card[2][n] - want).abs()
                    <= lr * g_err * 1.01 + 1e-6 * want.abs() + 1e-7).all(), n

    def test_remat_visual_same_loss_and_gradients(self, cuda_device):
        """Bottlenecks checkpointed (recomputed in the backward pass) give the
        step without it, BatchNorm's running update landing once. Gradients
        within 1e-4 of each leaf's largest: cuDNN's weight-gradient kernels
        accumulate in an order that varies between runs (seen: 1.9e-6 on a
        conv weight), where a recomputation that differed, or a second
        running update, would move them by O(1)."""
        import copy

        model = _tiny_train_model().to(cuda_device)
        remat = _tiny_train_model(remat_visual=True).to(cuda_device)
        remat.load_state_dict(model.state_dict())
        b = {k: torch.as_tensor(v).to(cuda_device) for k, v in _train_batch(2).items()}
        plain = _one_step(model, b, dropout=True)
        again = _one_step(remat, b, dropout=True)
        assert math.isclose(again[0], plain[0], rel_tol=1e-6)
        for n, g in plain[1].items():
            assert (again[1][n] - g).abs().max() <= 1e-4 * g.abs().max(), n
        for (n, x), (_, y) in zip(model.state_dict().items(), remat.state_dict().items()):
            torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6, msg=n)

    def test_bf16_full_width_step_is_finite(self, cuda_device):
        """Flagship widths (ResNet-101, wide-qkv fusion, 768x6 encoder, R2Gen
        512 x 3, 30001 logits) in bf16 over float32 masters, 2 + 2 images at
        224 px, 100 tokens: a finite loss, finite gradients and parameters, bf16
        parameters that moved (an update below half a bf16 ulp leaves the
        parameter and moves only its float32 master)."""
        from evoke_tpu_torch.models.finetune import FinetuneModel
        from evoke_tpu_torch.params import init_params_

        with torch.device(cuda_device):
            model = FinetuneModel(vocab_size=30000, max_seq_len=100, dtype=torch.bfloat16)
        init_params_(model, 0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        b = {k: torch.as_tensor(v).to(cuda_device)
             for k, v in _train_batch(3, image_size=224, seq=100, vocab=30000).items()}
        loss, grads, params = _one_step(model, b, dropout=True)
        assert math.isfinite(loss)
        assert all(torch.isfinite(g).all() for g in grads.values())
        assert all(torch.isfinite(p).all() for p in params.values())
        assert model.text_decoder.logit.weight.dtype == torch.bfloat16
        moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])]
        assert "text_decoder.logit.bias" in moved


PRETRAIN_TINY = {k: TRAIN_TINY[k] for k in ("output_dim", "encoder_hidden_size",
                                             "encoder_num_layers", "encoder_num_heads",
                                             "encoder_intermediate_size", "fusion_wide_qkv")}


def _pretrain_step(model, batch):
    """(losses, the gradients the optimizer got, the updated parameters) of
    one pretrain step, dropout off, on the CPU."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    opt = build_optimizer("RAdam", "pretrain", model, **TRAIN_LR)
    seen, step = {}, opt.step
    opt.step = lambda g: seen.update({k: v.detach().float().cpu() for k, v in g.items()
                                      if v is not None}) or step(g)
    out = make_train_step(model, opt, 0, task="pretrain", dropout=False)(
        TrainState(model, opt), batch)
    return ({k: float(v) for k, v in out.items()}, seen,
            {n: p.detach().float().cpu() for n, p in model.named_parameters()})


class TestPretrain:
    """The pretrain train step on the card against the CPU at float32, TF32
    off, TestTraining's tolerances: each loss 1e-4 relative; gradients
    outside the ResNet 1e-3 of (the leaf's largest + 1e-3 of the largest
    gradient), the ResNet's 3e-2 in L2 norm relative; updated parameters
    within the learning rate times their gradient's difference plus 1e-6
    relative."""

    def test_tiny_float32_step_card_equals_cpu(self, cuda_device):
        import copy

        from evoke_tpu_torch.models.pretrain import PretrainModel
        from evoke_tpu_torch.params import init_params_

        model = init_params_(PretrainModel(vocab_size=50, **PRETRAIN_TINY), 0)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bn3.weight"):
                    p.mul_(0.1)
        b = _train_batch(3)
        cpu = _pretrain_step(copy.deepcopy(model), {k: torch.as_tensor(v) for k, v in b.items()})
        card = _pretrain_step(copy.deepcopy(model).to(cuda_device),
                              {k: torch.as_tensor(v).to(cuda_device) for k, v in b.items()})
        for k, want in cpu[0].items():
            assert math.isclose(card[0][k], want, rel_tol=1e-4, abs_tol=1e-6), k
        gmax = max(g.abs().max().item() for g in cpu[1].values())
        num = den = 0.0
        for n, want in cpu[1].items():
            got = card[1][n]
            if n.startswith("visual_extractor."):
                num += float(((got - want) ** 2).sum())
                den += float((want ** 2).sum())
                continue
            assert (got - want).abs().max() <= 1e-3 * (want.abs().max() + 1e-3 * gmax), n
        assert math.sqrt(num / den) <= 3e-2
        for n, want in cpu[2].items():
            zero = torch.zeros_like(want)
            g_err = (card[1].get(n, zero) - cpu[1].get(n, zero)).abs()
            assert ((card[2][n] - want).abs()
                    <= TRAIN_LR["pt_lr"] * g_err * 1.01 + 1e-6 * want.abs() + 1e-7).all(), n


class TestRetrieval:
    """TopKIndex on the card against the CPU: integer-valued embeddings plant
    exact ties (repeated rows across chunks), one query with fewer candidates
    from other studies than k; ids equal, scores 1e-6. The database lives on
    the host (streamed in chunks from pinned memory) or on the card."""

    @pytest.mark.parametrize("where", ["host", "card"])
    def test_topk_ids_card_equal_cpu(self, cuda_device, where):
        from evoke_tpu_torch.retrieval.topk import TopKIndex

        rng = np.random.default_rng(0)
        db = rng.integers(-2, 3, size=(300, 24)).astype(np.float16)
        db[[40, 150, 299]] = db[7]
        codes = (np.arange(300) // 3).astype(np.int64)
        codes[:290] = 5
        queries = rng.integers(-2, 3, size=(50, 24)).astype(np.float16)
        qcodes = np.arange(50, dtype=np.int64) + 1000
        qcodes[0] = 5                        # 10 candidates from other studies, k 12
        ids = [str(i) for i in range(300)]
        want = TopKIndex(db, codes, ids, chunk_size=64, device="cpu").search(
            queries, qcodes, 12, query_chunk=16)
        source = torch.as_tensor(db) if where == "host" else torch.as_tensor(db).to(cuda_device)
        index = TopKIndex(source, codes, ids, chunk_size=64, device=cuda_device)
        got = index.search(queries, qcodes, 12, query_chunk=16)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        assert list(got[1][0, 10:]) == [0, 0]
        assert index.h2d_bytes == (db.nbytes * 4 if where == "host" else 0)  # 4 query chunks


# ---- the other decoding modes and the decoder zoo on the card ----

def _mode_case(dev, dtype, seed=0, kv_dtype=""):
    """(decoder, step over its log-probs, state0 factory) of the R2Gen decoder
    at full width (d 512, 8 heads, 30001 logits, 3 layers), 64 samples."""
    from evoke_tpu_torch.models.rm_decoder import RMDecoder
    from evoke_tpu_torch.params import init_params_

    with torch.device(dev):
        dec = init_params_(RMDecoder(vocab_size=_LOOP_VOCAB, num_layers=3, max_seq_len=30,
                                     dtype=dtype), 0).eval()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    att = torch.randn(_LOOP_BATCH, 49, 2048, generator=g, device=dev).to(dtype)
    mask = torch.ones(_LOOP_BATCH, 49, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        enc = dec.encode(att, mask)

    def state0(rows, length):
        with torch.inference_mode():
            return dec.init_decode_state(enc, rows, length, kv_dtype)

    def step(tok, t, st, **kw):
        return dec.decode_step(tok, t, st, mask, **kw)

    return dec, step, state0


_IDS = dict(bos_id=_LOOP_VOCAB - 2, eos_id=_LOOP_VOCAB - 1, pad_id=0,
            vocab_size=_LOOP_VOCAB + 1, max_len=30)


class TestDecodingModes:
    """SampleLoop, DiverseBeamLoop, DiverseSampleLoop and int8 caches at full
    width: captured == eager bit for bit (the same kernels in the same order;
    sampled modes draw the same numbers: the generator is reseeded at each
    load and a replay advances it as the eager step does), the same seed twice
    gives the same tokens and another seed others; replays count as launches."""

    @pytest.mark.parametrize("method,kw", [("greedy", {}), ("sample", dict(temperature=0.7)),
                                           ("top_k", dict(top_k=8)), ("top_p", dict(top_p=0.9))])
    def test_sample_loop_captured_equals_eager(self, cuda_device, method, kw):
        from evoke_tpu_torch.decode.beam import SampleLoop

        _, step, state0 = _mode_case(cuda_device, torch.float32)
        st = state0(_LOOP_BATCH, 8)
        runs = []
        for graphs in (True, False):
            loop = SampleLoop(step, st, _LOOP_BATCH, sample_method=method,
                              cache_schedule=_LOOP_SCHEDULE, graphs=graphs, **kw, **_IDS)
            assert loop.graphs == graphs
            out = []
            for seed in (0, 0, 1):
                loop.load(st, seed)
                out.append([x.clone() for x in loop.run()])
            torch.cuda.synchronize()
            runs.append(out)
        for a, b in zip(runs[0][0], runs[1][0]):
            assert torch.equal(a, b)
        assert torch.equal(runs[0][0][0], runs[0][1][0])            # seed 0 twice
        assert torch.equal(runs[0][0][0], runs[0][2][0]) == (method == "greedy")
        assert runs[0][0][0].unique().numel() > 3

    @pytest.mark.parametrize("ancestor_kv", [False, True])
    def test_diverse_beam_captured_equals_eager(self, cuda_device, ancestor_kv):
        from evoke_tpu_torch.decode.beam import DiverseBeamLoop

        _, step, state0 = _mode_case(cuda_device, torch.float32)
        st = state0(_LOOP_BATCH * 3, 30)
        res = []
        for graphs in (True, False):
            lineage_attention.launches = 0
            loop = DiverseBeamLoop(step, st, _LOOP_BATCH, beam_size=6, group_size=2,
                                   ancestor_kv=ancestor_kv, graphs=graphs, **_IDS)
            lineage_attention.launches = 0
            loop.load(st)
            res.append(loop.run())
            torch.cuda.synchronize()
            # 2 groups x 30 active steps x 3 layers through the lineage kernel
            assert lineage_attention.launches == (180 if ancestor_kv else 0)
        for a, b in zip(*res):
            assert torch.equal(a, b)
        assert res[0].seqs.shape == (_LOOP_BATCH, 6, 30)

    def test_diverse_sample_captured_equals_eager(self, cuda_device):
        from evoke_tpu_torch.decode.beam import DiverseSampleLoop

        _, step, state0 = _mode_case(cuda_device, torch.float32)
        st = state0(_LOOP_BATCH, 30)
        res = []
        for graphs in (True, False):
            loop = DiverseSampleLoop(step, st, _LOOP_BATCH, group_size=3,
                                     sample_method="sample", graphs=graphs, **_IDS)
            loop.load(st, 5)
            res.append(loop.run())
            torch.cuda.synchronize()
        for a, b in zip(*res):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_int8_beam_captured_equals_eager(self, cuda_device, dtype):
        """Reorder caches (int8 keeps 'auto' off the lineage kernel), the fused
        tail: K1 = 0, K2 = 1 a step."""
        from evoke_tpu_torch.decode.beam import BeamLoop

        _, step, state0 = _mode_case(cuda_device, dtype, kv_dtype="int8")
        st = state0(_LOOP_BATCH * 3, 8)
        assert st["cache_k"][0].dtype == torch.int8

        def fused(tok, t, s):
            return step(tok, t, s, return_topk=3, topk_suppress=(4,))

        res = []
        for graphs in (True, False):
            loop = BeamLoop(fused, st, _LOOP_BATCH, beam_size=3, raw_logits=True,
                            fused_topk=True, cache_schedule=_LOOP_SCHEDULE, early_stop=False,
                            graphs=graphs, **_IDS)
            lineage_attention.launches = fused_logit_topk.launches = 0
            loop.load(st)
            res.append(loop.run())
            torch.cuda.synchronize()
            assert (lineage_attention.launches, fused_logit_topk.launches) == (0, 30)
        for a, b in zip(*res):
            assert torch.equal(a, b)


ZOO_CARD = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
                encoder_num_heads=2, encoder_intermediate_size=64, d_model=64, d_ff=64,
                num_heads=2, num_layers=2, rm_d_model=64, fusion_num_heads=2,
                fusion_intermediate_size=64, sk_fusion_num_layers=1, max_seq_len=16,
                fusion_wide_qkv=False)


class TestZoo:
    """Each decoder and ViT-B/32 in a small FinetuneModel (head dim 32, the
    lineage kernel's smallest), float32: the serving path on the card (the
    lineage kernel, captured) gives the CPU's tokens (the plain version).
    R2Gen runs its fused tail (K2) on the card and its plain version here."""

    @pytest.mark.parametrize("kind,visual", [("cmn", "resnet101"), ("causal", "resnet101"),
                                             ("bertgen", "resnet101"), ("r2gen", "vit_b32")])
    def test_serving_card_equals_cpu(self, cuda_device, kind, visual):
        import copy

        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.models.finetune import FinetuneModel
        from evoke_tpu_torch.params import init_params_
        from evoke_tpu_torch.train.steps import make_generate_step

        class Tok:
            bos_id, eos_id, pad_id, unk_id = 48, 49, 0, 4

            def get_vocab_size(self):
                return 50

        extra = dict(cmm_size=64, cmm_dim=64, cmn_topk=8) if kind == "cmn" else {}
        model = init_params_(FinetuneModel(vocab_size=50, decoder_kind=kind,
                                           visual_encoder=visual, **ZOO_CARD, **extra), 0)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.startswith("text_decoder.") and name.endswith(("logit.weight",
                                                                       "lm_head.weight")):
                    p.mul_(8.0)
        b = _train_batch(2)
        out = {}
        for dev in ("cpu", cuda_device):
            m = copy.deepcopy(model).to(dev).eval()
            gen = make_generate_step(m, Tok(), DecodeConfig(beam_size=3), 16,
                                     with_indication=True, serving=True, all_samples=True,
                                     device=dev)
            lineage_attention.launches = 0
            out[str(dev)] = gen({k: torch.as_tensor(v).to(dev) for k, v in b.items()}).cpu()
            if dev != "cpu":
                (loop, _), = gen.loops.values()
                # 2 layers a step: the eager step of each cache phase before the
                # capture, then the steps replayed
                assert loop.graphs and lineage_attention.launches == 2 * (
                    len(gen.schedule) + loop.steps_run)
        assert torch.equal(out["cpu"], out["cuda"])
        assert out["cpu"].unique().numel() > 3


class TestDataParallel:
    """A real NCCL process group of size 1 in this process (the join path of
    ``cli serve --decode.serve_dp``): ReportServer and ContinuousServer over
    the 1-rank mesh serve, captured, what they serve on one device, with K1
    and K2 launched as often."""

    def test_one_rank_nccl_serve_equals_one_device(self, cuda_device):
        import torch.distributed as dist

        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.core.mesh import (MeshSpec, create_mesh, init_distributed,
                                               rendezvous_file)
        from evoke_tpu_torch.decode.continuous import ContinuousServer
        from evoke_tpu_torch.decode.forcing import synthetic_tokenizer
        from evoke_tpu_torch.serve import ReportServer

        model = _engine_model(cuda_device, torch.float32)
        tok = synthetic_tokenizer(_ENGINE_VOCAB, spell_ids=True)
        batches = _engine_loader(2, 8)

        def serve(mesh):
            lineage_attention.launches = fused_logit_topk.launches = 0
            batch = ReportServer(model, tok, DecodeConfig(beam_size=_ENGINE_BEAM),
                                 _ENGINE_LEN, device=cuda_device, mesh=mesh)
            recs = batch.serve(batches, with_indication=True)
            counts = (lineage_attention.launches, fused_logit_topk.launches)
            cont = ContinuousServer(model, tok, max_seq_len=_ENGINE_LEN, slots=8,
                                    beam_size=_ENGINE_BEAM, seg_steps=10, device=cuda_device,
                                    mesh=mesh)
            crecs, _ = cont.serve(batches)
            assert cont.loop.graphs and cont.ancestor_kv and cont.fused_topk
            return recs, counts, crecs

        one = serve(None)
        init_distributed("nccl", rendezvous_file(), 1, 0, device="cuda")
        try:
            mesh = create_mesh(MeshSpec(dp=1), device="cuda")
            assert mesh.group is not None and mesh.device == torch.device("cuda", 0)
            got = serve(mesh)
        finally:
            dist.destroy_process_group()
        assert one[1][1] > 0 and one[1][0] == 3 * one[1][1]
        assert got == one


class TestStackedCLN:
    """The decode steps' stacked CLN pass (models/rm_decoder.py): every
    conditional norm's memory MLPs as one float32 ``addmm`` and one
    ``baddbmm`` over a pack of their weights, refreshed in place."""

    def test_flagship_bf16_beam_loop_captured_equals_eager(self, cuda_device):
        """Every step takes the stacked pass, captured (the eager step of each
        cache phase, then the captures; a replay repeats its capture) and
        eager, bit-equal."""
        dec, step, state0, kw = _loop_case(cuda_device, torch.bfloat16, "fused", False)
        assert dec._cln_pack is not None
        n0 = dec.stacked_cln_steps
        cap, got = _run_loop(step, state0, kw, graphs=True)
        n1 = dec.stacked_cln_steps
        eag, want = _run_loop(step, state0, kw, graphs=False)
        steps = _LOOP_SCHEDULE[-1]
        assert cap.graphs and not eag.graphs and cap.steps_run == eag.steps_run == steps
        assert n1 - n0 == len(_LOOP_SCHEDULE) + steps
        assert dec.stacked_cln_steps - n1 == steps
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert got.seqs.unique().numel() > 3

    def test_stacked_gemms_are_float32(self, cuda_device):
        """The bf16 flagship's pack and its (scale, shift) are float32 and
        hold the per-norm MLPs computed in float64 within 1e-5 (a TF32 or
        bf16 product would miss by ~1e-3)."""
        dec, _, _, _ = _loop_case(cuda_device, torch.bfloat16, "fused", False)
        g = torch.Generator(device=cuda_device)
        g.manual_seed(3)
        mem = torch.randn(_LOOP_BATCH * _LOOP_BEAM, 3 * 512, generator=g, device=cuda_device)
        with torch.inference_mode():
            got = dec.cln_scale_shift(mem)
        assert all(t.dtype == torch.float32 for t in dec._cln_pack)
        assert got.dtype == torch.float32 and got.shape == (18, mem.shape[0], 512)
        m = mem.double()
        for i, (m0, m1, v) in enumerate(dec._cln_sources()):
            w = lambda dense: (dense.weight.double(), dense.bias.double())
            (w0, b0), (w1, b1) = w(m0), w(m1)
            want = v.double() + torch.relu(m @ w0.t() + b0) @ w1.t() + b1
            torch.testing.assert_close(got[i].double(), want, rtol=1e-5, atol=1e-5)

    def test_finetune_eval_decode_reads_the_refreshed_pack(self, cuda_device):
        """The finetune loop's val / test decode (``serving=False``, captured)
        after a train step: the next call refreshes the pack in place (same
        addresses, so the captured graphs read it) and decodes what a fresh
        model with the trained weights decodes eagerly."""
        from evoke_tpu_torch.core.config import DecodeConfig
        from evoke_tpu_torch.models.finetune import FinetuneModel
        from evoke_tpu_torch.params import init_params_
        from evoke_tpu_torch.train.optim import build_optimizer
        from evoke_tpu_torch.train.steps import TrainState, make_generate_step, make_train_step

        class Tok:
            bos_id, eos_id, pad_id, unk_id = 48, 49, 0, 4

            def get_vocab_size(self):
                return 50

        def build():
            return FinetuneModel(vocab_size=50, **ZOO_CARD).to(cuda_device)

        def dev_batch(seed):
            return {k: torch.as_tensor(v).to(cuda_device) for k, v in _train_batch(seed).items()}

        model = init_params_(build(), 0)
        dec = model.text_decoder
        gen = make_generate_step(model, Tok(), DecodeConfig(beam_size=3), 16,
                                 with_indication=True, serving=False, device=cuda_device)
        batch = dev_batch(2)
        gen(batch)
        assert gen.captured and all(loop.graphs for loop, _ in gen.loops.values())
        ptrs = [t.data_ptr() for t in dec._cln_pack]
        old = [t.clone() for t in dec._cln_pack]
        n = dec.cln_pack_refreshes
        opt = build_optimizer("RAdam", "finetune", model, **TRAIN_LR)
        make_train_step(model, opt, 0, with_indication=True, dropout=False)(
            TrainState(model, opt), dev_batch(1))
        got = gen(batch)
        torch.cuda.synchronize()
        assert dec.cln_pack_refreshes == n + 1
        assert [t.data_ptr() for t in dec._cln_pack] == ptrs
        assert not torch.equal(dec._cln_pack[0], old[0])
        fresh = build()
        fresh.load_state_dict(model.state_dict())
        want = make_generate_step(fresh, Tok(), DecodeConfig(beam_size=3), 16,
                                  with_indication=True, serving=False, device=cuda_device,
                                  graphs=False)(batch)
        for a, b in zip(dec._cln_pack, fresh.text_decoder._cln_pack):
            assert torch.equal(a, b)
        assert torch.equal(got, want)


_MLA_TOY = dict(vocab_size=97, max_position_embeddings=256, hidden_size=64,
                intermediate_size=128, moe_intermediate_size=32, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
                n_routed_experts=8, kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=16,
                qk_nope_head_dim=16, num_experts_per_tok=2, first_k_dense_replace=1)


class TestMLAMoE:
    """The mla_moe decoder on the card: its vocabulary tail through K2 at the
    language model's shape, and its decode step captured in CUDA graphs."""

    def test_fused_topk_at_the_language_model_tail(self, cuda_device):
        """Kimi-VL-A3B's head: 768 beam rows (256 studies x beam 3, four row
        passes), D 2048, V 163,840, a zero bias; UNK suppressed."""
        g = torch.Generator(device=cuda_device)
        g.manual_seed(20)
        h = torch.randn(768, 2048, generator=g, device=cuda_device).to(torch.bfloat16)
        w = (torch.randn(163840, 2048, generator=g, device=cuda_device) / math.sqrt(2048)
             ).to(torch.bfloat16)
        b = torch.zeros(163840, dtype=torch.bfloat16, device=cuda_device)
        got = fused_logit_topk(h, w, b, 3, (4,))
        _assert_topk_close(got, fused_logit_topk_plain(h, w, b, 3, (4,)), torch.bfloat16)

    @pytest.mark.parametrize("ancestor_kv", [True, False], ids=["ancestor", "reorder"])
    def test_captured_decode_step_equals_eager(self, cuda_device, ancestor_kv):
        """A toy bf16 decoder (hidden 64, 1 dense + 2 MoE layers of 8 experts)
        through ``BeamLoop`` with the fused tail, 4 cache phases: captured and
        eager give bit-equal results, and the expert ledger counts every
        replayed step."""
        from evoke_tpu_torch.decode.beam import BeamLoop
        from evoke_tpu_torch.models.mla_moe_decoder import MLAMoEDecoder
        from evoke_tpu_torch.params import init_params_

        b, beam, schedule = 4, 3, (4, 8, 12, 16)
        with torch.device(cuda_device):
            dec = init_params_(MLAMoEDecoder(96, 64, 16, torch.bfloat16, _MLA_TOY), 0).eval()
        g = torch.Generator(device=cuda_device)
        g.manual_seed(1)
        att = torch.randn(b, 5, 64, generator=g, device=cuda_device)
        with torch.inference_mode():
            state0 = dec.init_decode_state(dec.encode(att), b * beam, schedule[0])

        def step(tok, t, st):
            return dec.decode_step(tok, t, st, return_topk=beam, topk_suppress=(4,))

        results = []
        for graphs in (True, False):
            loop = BeamLoop(step, state0, b, bos_id=94, eos_id=95, pad_id=0, vocab_size=97,
                            beam_size=beam, max_len=schedule[-1], raw_logits=True,
                            fused_topk=True, early_stop=False, cache_schedule=schedule,
                            ancestor_kv=ancestor_kv, graphs=graphs)
            dec.reset_expert_ledger()
            loop.load(state0)
            results.append(loop.run())
            torch.cuda.synchronize()
            led = dec.read_expert_ledger()
            assert led["calls"].tolist() == [0, schedule[-1]]
            assert led["rows"][1].sum() == schedule[-1] * b * beam * 2 * 2
        for x, y in zip(*results):
            assert torch.equal(x, y)
        assert results[0].seqs.unique().numel() > 3
