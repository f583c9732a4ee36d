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
