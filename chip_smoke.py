"""Chip smoke test of the PyTorch / CUDA port (evoke_tpu_torch) on one H100.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order (any failure raises and exits non-zero; nothing is skipped):

1. the device: torch's name and nvidia-smi's name and power limit;
2. build every kernel from csrc/ (one nvcc per source, in parallel), then
   hold each against its plain PyTorch version on the card at the shapes its
   path gives it, with the tolerance stated, and time kernel, plain version
   and one library call (CUDA events, median; before each launch a 64 MB
   buffer is zeroed to evict the L2, so host time that outlasts the zeroing
   is timed too) beside the bound (bytes over 3.35 TB/s or operations over
   the peak rate, the larger). Each kernel (K1 and K2 with their library
   calls) is timed a second way, device-only: the device spins ~0.1 ms
   before each launch, so the host enqueues the call meanwhile and the
   events see only the device's work. K1 (lineage attention) runs at the
   serving shape (64 samples x beam 3, d 512, 8 heads) at L 13 and 100, batch
   and ring mode, bf16 and float32, with uniformly random lineages, and at L
   100 bf16 with converged lineages (one shared ancestor row in every slot
   but the last 5, as a real beam has); kernel and SDPA are timed in turns
   both ways, the wrapper's host time is read on the host clock, its
   registers, shared memory and spills from the -Xptxas -v log beside its
   launch plan, and its device-only time at each cache length of the serving
   schedule is printed on one line. K2 (fused logit + top-k) runs at the
   flagship's N 192 and the CLI's N 96 (32 studies x beam 3) in bf16, and at
   N 192 in float32, with and without a suppressed id; kernel and library
   call (addmm with the bias, logsumexp, topk) are timed in turns, library,
   kernel, kernel, library; K2's wrapper's host time per call is read on the
   host clock, and its registers, shared memory and spills from the
   -Xptxas -v log. K3 (fusion attention) runs at the CLI default layout (32
   anchors, 64 images) and the flagship layout (64 anchors, 128 images), T 50,
   8 heads, dk 2048, bf16 and float32, on strided views as the module passes
   them, with anchors of 0 (self slot), 1 and 3 partners;
3. a correctness check on a small input: the full-width flagship at float32
   decodes two studies through the serving path (lineage kernel + fused tail)
   and through the eval path (reorder caches, plain vocab tail); the best
   beams must agree (float32: the attended sets are identical);
4. the main path: the full-width flagship (ResNet-101 @ 224, wide-qkv
   grouped fusion, 768x6 text encoder + BertCrossLayer, R2Gen decoder d 512,
   30001 logits, bf16) with seeded random weights serves 3 batches of 64
   studies (64 anchors + 64 aux views, with indication) through ReportServer
   at beam 3; every launch counter is set to 0 just before and read just
   after, and each kernel must have been launched (K1 three times per step);
5. the fusion module at full width (d_vf 2048, wide qkv, 8 heads, T 50, the
   flagship layout): BatchedCrossViewAttention(use_pallas=True) against the
   dense route and the grouped route (max_partners=3) with one weight set, at
   float32 and bf16; K3's count is set to 0 before and must rise;
6. the serve CLI in-process at full width and every CLI default but bf16
   (ResNet-101 @ 224, dense fusion, 768x6 encoder, R2Gen 512x3, beam 3, batch
   32 + 32 aux, uint8 images) over a synthetic dataset written to a temporary
   directory with a 30000-word tokenizer; one non-empty report per test
   study, K1:K2 launches 3:1;
7. a JSON line of every ported kernel, then the result line.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense bf16 tensor / fp32
K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 3.2e-2}   # bf16: one ulp at |x| in [4, 8)
K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}
# K3: float32 sums over dk 2048 in another order; bf16 one output ulp at |x| in [4, 8)
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}
# fusion module, kernel route vs dot_attention routes: float32 summation order;
# bf16 the dense route rounds the probabilities to bf16 and fc_o rounds again
# (4 ulps at |x| in [2, 4))
FUSION_TOL = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2}
PARTNER_CYCLE = (0, 1, 3, 0)   # same-study partners of anchor i: PARTNER_CYCLE[i % 4]
# each hand-written kernel of the serving path by a fragment of its name, for
# the profile digest (a fragment that matches no launch fails the profile)
PORTED_KERNELS = ("lineage_kernel", "tile_kernel_bf16", "merge_kernel_warp")


def log(*a):
    print(*a, flush=True)


HOST_HEADSTART_CYCLES = 200_000    # ~0.1 ms of device spin before each timed launch


def time_samples(fn, flush, reps, device_only=False):
    """CUDA-event times of ``reps`` calls of ``fn``, the L2 evicted before
    each by zeroing ``flush`` (> 50 MB). Host time of ``fn`` that outlasts
    the zeroing shows in the events. ``device_only``: the device also spins
    before the start event, so the host enqueues the call's launches
    meanwhile and the events time the device's work alone."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if device_only:
            torch.cuda._sleep(HOST_HEADSTART_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def time_ms(fn, flush, reps=30, device_only=False):
    """Median CUDA-event time of ``fn`` (see ``time_samples``)."""
    return statistics.median(time_samples(fn, flush, reps, device_only))


def host_us(fn, calls=1000):
    """Median host-clock time of one call of ``fn`` in microseconds: the
    device is synchronized between calls, not inside the timed span."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_lineage(dev, flush, g, dtype, lmax, ring, lineage="random"):
    from evoke_tpu_torch.ops.lineage_attention import (attended_rows, lineage_attention,
                                                       lineage_attention_plain,
                                                       lineage_masks)

    b, kbeam, d, heads = 64, 3, 512, 8
    n, dh = b * kbeam, d // heads
    q = torch.randn(n, d, generator=g, device=dev).to(dtype)
    ck = torch.randn(n, lmax, d, generator=g, device=dev).to(dtype)
    cv = torch.randn(n, lmax, d, generator=g, device=dev).to(dtype)
    anc = torch.randint(0, kbeam, (b, kbeam, lmax), generator=g, device=dev,
                        dtype=torch.int32)
    if lineage == "converged":   # one shared ancestor row in every slot but the last 5
        anc[:, :, :lmax - 5] = torch.randint(0, kbeam, (b, 1, 1), generator=g, device=dev,
                                             dtype=torch.int32)
    if ring:
        pos = int(torch.randint(0, lmax, (1,), generator=g, device=dev))
        age = torch.randint(0, lmax, (b,), generator=g, device=dev, dtype=torch.int32)
    else:
        pos, age = lmax - 1, None
    got = lineage_attention(q, ck, cv, anc, pos, heads, age=age)
    want = lineage_attention_plain(q, ck, cv, anc, pos, heads, age=age)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = K1_TOL[dtype]
    what = (f"lineage_attention L={lmax} {'ring' if ring else 'batch'} {str(dtype)[6:]}"
            + ("" if lineage == "random" else f" {lineage} lineages"))
    if not err <= tol:
        raise AssertionError(f"{what}: max abs err {err} > {tol}")
    # library yardstick: SDPA with the boolean lineage mask over the kbeam*L keys
    mask = lineage_masks(anc, pos, age)                                 # [B,1,k,kL]
    qh = q.reshape(b, kbeam, heads, dh).transpose(1, 2)
    kh = ck.reshape(b, kbeam * lmax, heads, dh).transpose(1, 2)
    vh = cv.reshape(b, kbeam * lmax, heads, dh).transpose(1, 2)
    kernel = functools.partial(lineage_attention, q, ck, cv, anc, pos, heads, age=age)
    library = functools.partial(F.scaled_dot_product_attention, qh, kh, vh, attn_mask=mask)
    ms, lib_ms = time_in_turns(kernel, library, flush)
    dev_ms, dev_lib_ms = time_in_turns(kernel, library, flush, device_only=True)
    wrapper_us = host_us(kernel)
    plain_ms = time_ms(lambda: lineage_attention_plain(q, ck, cv, anc, pos, heads, age=age),
                       flush)
    # bytes this data needs: the K and V rows some query attends, q, out, anc, age
    rows = int(attended_rows(anc, pos, age).sum())
    isz = q.element_size()
    nbytes = 2 * rows * d * isz + 2 * n * d * isz + anc.numel() * 4 + (b * 4 if ring else 0)
    flops = 4 * kbeam * rows * d          # QK and PV over the attended rows
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"kernel {what}: max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}, "
        f"{rows} of {n * lmax} rows attended); device-only ms={dev_ms:.4f} "
        f"sdpa_ms={dev_lib_ms:.4f}; wrapper host {wrapper_us:.1f} us/call")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, device_only_ms=dev_ms, device_only_library_ms=dev_lib_ms,
                wrapper_host_us=wrapper_us, attended_rows=rows)


def lineage_schedule_times(dev, flush, g, reps=10):
    """K1's device-only time at each cache length of the serving schedule
    (beam 3, max_len 100, 8 phases), bf16, batch mode at pos = L - 1, random
    lineages: what the serving profile's per-launch average is read against."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.train.steps import cache_schedule

    b, kbeam, d, heads = 64, 3, 512, 8
    out = {}
    for lmax in cache_schedule(DecodeConfig(beam_size=kbeam), 100, serving=True):
        q = torch.randn(b * kbeam, d, generator=g, device=dev).bfloat16()
        ck = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
        cv = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
        anc = torch.randint(0, kbeam, (b, kbeam, lmax), generator=g, device=dev,
                            dtype=torch.int32)
        out[lmax] = time_ms(lambda: lineage_attention(q, ck, cv, anc, lmax - 1, heads), flush,
                            reps=reps, device_only=True)
    log("K1 bf16 device-only ms by cache length (pos = L - 1, 10 launches each): "
        + " ".join(f"L{lmax}={ms:.4f}" for lmax, ms in out.items()))
    return out


def time_in_turns(kernel, library, flush, reps=30, device_only=False):
    """Kernel and library call timed in turns (library, kernel, kernel,
    library) within one call: the median of each one's pooled samples."""
    samples = {"kernel": [], "library": []}
    for name, fn in (("library", library), ("kernel", kernel), ("kernel", kernel),
                     ("library", library)):
        samples[name] += time_samples(fn, flush, reps, device_only)
    return statistics.median(samples["kernel"]), statistics.median(samples["library"])


def ptxas_report(log_path, kernels):
    """Registers, static shared memory and spill bytes of each instantiation
    of ``kernels`` from nvcc's -Xptxas -v log, by name: ``kernel<3>``,
    ``kernel<bf16, 64, 3>`` (a leading type argument, then the integers)."""
    types = {"13__nv_bfloat16": "bf16", "f": "float"}
    out, name = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"(?:entry function '|Function properties for )(\w+)", line)
            if m:
                k = re.search(r"(%s)I(%s)?((?:Li\d+E)+)" % ("|".join(kernels), "|".join(types)),
                              m.group(1))
                name = None
                if k:
                    targs = [types[k.group(2)]] if k.group(2) else []
                    targs += re.findall(r"Li(\d+)E", k.group(3))
                    name = f"{k.group(1)}<{', '.join(targs)}>"
                continue
            if name is None:
                continue
            rec = out.setdefault(name, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rec.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rec["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                rec["static_smem"] = int(m.group(1)) if m else 0
    return out


def log_ptxas(report):
    for name, rec in sorted(report.items()):
        log(f"ptxas {name}: {rec.get('registers')} registers, {rec.get('static_smem')} B "
            f"static smem, spills {rec.get('spill_stores')} / {rec.get('spill_loads')} B")


def check_fused_topk(dev, flush, g, dtype, suppress, n):
    from evoke_tpu_torch.ops.fused_logit_topk import (fused_logit_topk, fused_logit_topk_plain,
                                                      launch_plan)

    d, v, k = 512, 30001, 3
    h = torch.randn(n, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(v, d, generator=g, device=dev) / math.sqrt(d)).to(dtype)
    b = (torch.randn(v, generator=g, device=dev) * 0.1).to(dtype)
    gv, gi, gl = fused_logit_topk(h, w, b, k, suppress)
    pv, pi, pl = fused_logit_topk_plain(h, w, b, k, suppress)
    torch.cuda.synchronize()
    tol = K2_TOL[dtype]
    err = (gv - pv).abs().max().item()
    lse_err = (gl - pl).abs().max().item()
    # an index may differ from the plain version's only at a near-tie
    bad_idx = ((gi != pi) & ((gv - pv).abs() > tol)).sum().item()
    if not (err <= tol and lse_err <= 1e-3 and bad_idx == 0):
        raise AssertionError(f"fused_logit_topk N={n} {dtype} suppress={suppress}: vals err "
                             f"{err} (tol {tol}), lse err {lse_err} (tol 1e-3), {bad_idx} "
                             "index mismatches outside near-ties")
    if any((gi == s).any().item() for s in suppress):
        raise AssertionError("fused_logit_topk returned a suppressed id")

    def library():   # the same function in PyTorch calls: bias in the product's epilogue
        logits = torch.addmm(b, h, w.t())
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, k)

    kernel = functools.partial(fused_logit_topk, h, w, b, k, suppress)
    ms, lib_ms = time_in_turns(kernel, library, flush)
    dev_ms, dev_lib_ms = time_in_turns(kernel, library, flush, device_only=True)
    wrapper_us = host_us(kernel)
    plain_ms = time_ms(lambda: fused_logit_topk_plain(h, w, b, k, suppress), flush)
    isz = h.element_size()
    nbytes = (v * d + n * d + v) * isz + n * k * 8 + n * 4
    bms, by = bound_ms(nbytes, 2 * n * d * v, dtype)
    log(f"kernel fused_logit_topk N={n} {str(dtype)[6:]} suppress={list(suppress)}: "
        f"max_abs_err={err:.3e} (tol {tol}) lse_err={lse_err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} addmm_lse_topk_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}); "
        f"device-only ms={dev_ms:.4f} addmm_lse_topk_ms={dev_lib_ms:.4f}; wrapper host "
        f"{wrapper_us:.1f} us/call")
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               library_ms=lib_ms, device_only_ms=dev_ms, device_only_library_ms=dev_lib_ms,
               wrapper_host_us=wrapper_us)
    if dtype == torch.bfloat16:
        out["plan"] = launch_plan(n, d, v, k, sms=torch.cuda.get_device_properties(dev)
                                  .multi_processor_count)
    return out


def partner_layout(n_anchor):
    """Anchors first, then aux views: anchor i has PARTNER_CYCLE[i % 4]
    partner views (one aux slot per partner, so n_aux == n_anchor). Returns
    pids [2 * n_anchor] int32 and the module's attend mask [Q, B] bool
    (partners, or the self slot for a partnerless anchor)."""
    pids = list(range(n_anchor))
    for i in range(n_anchor):
        pids += [i] * PARTNER_CYCLE[i % 4]
    assert len(pids) == 2 * n_anchor
    pids = np.asarray(pids, np.int32)
    b = len(pids)
    attend = (pids[:n_anchor, None] == pids[None, :]) & (
        np.arange(n_anchor)[:, None] != np.arange(b)[None, :])
    attend |= (np.arange(n_anchor)[:, None] == np.arange(b)[None, :]) & ~attend.any(
        1, keepdims=True)
    return pids, attend


def sdpa_backend(q, k, v, mask):
    """The first SDPA backend that takes these inputs (flash, efficient,
    cudnn, math): what a plain F.scaled_dot_product_attention call runs."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore")    # each refusal warns its reason
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            return be.name
        except RuntimeError:
            continue
    return "none"


def check_fusion_attention(dev, flush, g, dtype, n_anchor, library=True):
    from evoke_tpu_torch.ops.fusion_attention import (masked_cross_view_attention,
                                                      masked_cross_view_attention_plain)

    t, h, dk = 50, 8, 2048
    _, attend_np = partner_layout(n_anchor)
    b = attend_np.shape[1]
    n = b * t
    # strided views of projection outputs, as BatchedCrossViewAttention passes them
    xq = torch.randn(n_anchor, t, h * dk, generator=g, device=dev).to(dtype)
    xk = torch.randn(b, t, h * dk, generator=g, device=dev).to(dtype)
    xv = torch.randn(b, t, h * dk, generator=g, device=dev).to(dtype)
    q = xq.reshape(n_anchor, t, h, dk).transpose(1, 2)
    k = xk.reshape(n, h, dk).transpose(0, 1)
    v = xv.reshape(n, h, dk).transpose(0, 1)
    attend = torch.as_tensor(attend_np, device=dev)
    got = masked_cross_view_attention(q, k, v, attend, t)
    want = masked_cross_view_attention_plain(q, k, v, attend, t)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = K3_TOL[dtype]
    if not err <= tol:
        raise AssertionError(f"fusion_attention Q={n_anchor} B={b} {dtype}: max abs err "
                             f"{err} > {tol}")
    del want
    kernel = functools.partial(masked_cross_view_attention, q, k, v, attend, t)
    ms = time_ms(kernel, flush, reps=10)
    dev_ms = time_ms(kernel, flush, reps=10, device_only=True)
    plain_ms = time_ms(lambda: masked_cross_view_attention_plain(q, k, v, attend, t), flush,
                       reps=5)
    lib_ms, backend = None, "not timed"
    if library:
        # library yardstick: SDPA, boolean [Q, 1, 1, N] mask, k/v expanded to Q
        mask = attend.repeat_interleave(t, dim=1)[:, None, None, :]
        ke, ve = k[None].expand(n_anchor, h, n, dk), v[None].expand(n_anchor, h, n, dk)
        backend = sdpa_backend(q, ke, ve, mask)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, attn_mask=mask),
                         flush, reps=5)
        del mask, ke, ve
    # this data's work: q, out and mask once, the K/V rows of every sample some
    # anchor attends once; QK and PV over each anchor's attended samples only
    isz = q.element_size()
    rows = int(attend_np.any(axis=0).sum()) * t
    nbytes = 2 * q.numel() * isz + 2 * rows * h * dk * isz + attend_np.size
    flops = 4 * t * t * dk * h * int(attend_np.sum())
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"kernel fusion_attention Q={n_anchor} B={b} T={t} h={h} dk={dk} "
        f"{str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms if lib_ms is None else f'{lib_ms:.4f}'} "
        f"(backend {backend}) bound_ms={bms:.4f} ({by}); device-only ms={dev_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, device_only_ms=dev_ms, sdpa_backend=backend)


def check_fusion_module(dev, seed):
    """BatchedCrossViewAttention at full width: the kernel route against the
    dense and grouped dot_attention routes, one weight set, float32 and bf16.
    Returns K3's launches in this phase (its count is set to 0 first)."""
    from evoke_tpu_torch.models.fusion import BatchedCrossViewAttention, same_study_matrix
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.params import init_params_

    d, heads, t, n_anchor = 2048, 8, 50, 64
    pids_np, _ = partner_layout(n_anchor)
    pids = torch.as_tensor(pids_np, device=dev)
    valid = torch.ones(len(pids_np), dtype=torch.bool, device=dev)
    study = same_study_matrix(pids[:n_anchor], pids, valid[:n_anchor], valid)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    x = torch.randn(len(pids_np), t, d, generator=g, device=dev)
    with torch.device(dev):
        ref = init_params_(BatchedCrossViewAttention(d, heads, wide_qkv=True), seed)
    weights = ref.state_dict()
    del ref
    masked_cross_view_attention.launches = 0
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        outs = {}
        for name, kw in (("kernel", dict(use_pallas=True)), ("dense", {}),
                         ("grouped", dict(max_partners=3))):
            with torch.device(dev):
                m = BatchedCrossViewAttention(d, heads, wide_qkv=True, dtype=dtype, **kw)
            m.load_state_dict(weights)
            with torch.inference_mode():
                xd = x.to(dtype)
                outs[name] = m(xd[:n_anchor], xd, study).float()
            del m
        torch.cuda.synchronize()
        tol = FUSION_TOL[dtype]
        for other in ("dense", "grouped"):
            err = (outs["kernel"] - outs[other]).abs().max().item()
            errs[f"{str(dtype)[6:]}_kernel_vs_{other}"] = err
            if not err <= tol:
                raise AssertionError(f"fusion module {dtype}: kernel route vs {other} "
                                     f"route max abs err {err} > {tol}")
        log(f"fusion module (d 2048, wide qkv, 8 heads, T 50, Q 64, B 128) "
            f"{str(dtype)[6:]}: kernel vs dense {errs[f'{str(dtype)[6:]}_kernel_vs_dense']:.3e}"
            f", vs grouped {errs[f'{str(dtype)[6:]}_kernel_vs_grouped']:.3e} (tol {tol})")
    n_k3 = masked_cross_view_attention.launches
    if n_k3 <= 0:
        raise AssertionError("fusion module phase: masked_cross_view_attention never launched")
    torch.cuda.empty_cache()
    return n_k3, errs


def serve_cli(seed):
    """The serve CLI in-process at full width over a synthetic dataset: every
    CLI default but bf16. Returns the phase's numbers."""
    import contextlib
    import io
    import os
    import tempfile

    from evoke_tpu_torch import cli, serve
    from evoke_tpu_torch.data.datasets import load_annotation, parse_finetune
    from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
    from evoke_tpu_torch.data.tokenizer import WordTokenizer
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        t0 = time.perf_counter()
        ann = write_synthetic_dataset(root, n_train=8, n_val=0, n_test=160, image_size=224,
                                      seed=seed)
        has_ind, no_ind = parse_finetune(load_annotation(ann), "test")
        if len(has_ind) < 96 or not no_ind:
            raise AssertionError(f"synthetic split: {len(has_ind)} studies with "
                                 f"indication, {len(no_ind)} without")
        # a 30000-word vocab where build_tokenizer looks: the dataset's words first
        words = {w: i for w, i in WordTokenizer.train(
            r["report"] for r in load_annotation(ann)["train"]).vocab.items()
            if w not in ("[BOS]", "[EOS]")}                  # re-appended last
        for i in range(30000 - 2 - len(words)):
            words[f"w{i}"] = len(words)
        tok = WordTokenizer(words)
        assert tok.get_vocab_size() == 30000
        tok_dir = os.path.join(root, "tok")
        os.makedirs(tok_dir)
        tok.save(os.path.join(tok_dir, "mimic_cxr_wordlevel_uncased_tokenizer.json"))
        log(f"cli data: {len(has_ind)} test studies with indication, {len(no_ind)} "
            f"without, 224 px .npy, {time.perf_counter() - t0:.1f}s")

        stats = []
        serve_fn = serve.ReportServer.serve

        def recording_serve(self, *a, **kw):
            out = serve_fn(self, *a, **kw)
            stats.append(dict(self.stats))
            return out

        serve.ReportServer.serve = recording_serve
        buf = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        lineage_attention.launches = 0
        fused_logit_topk.launches = 0
        masked_cross_view_attention.launches = 0
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["serve", "--data.ann_path", ann, "--data.image_dir", root,
                               "--data.tokenizer_dir", tok_dir,
                               "--trainer.result_dir", os.path.join(root, "results"),
                               "--model.dtype", "bfloat16"])
            torch.cuda.synchronize()
        finally:
            serve.ReportServer.serve = serve_fn
        wall = time.perf_counter() - t0
        n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
        n_k3 = masked_cross_view_attention.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        printed = buf.getvalue().strip().splitlines()
        log("cli stdout: " + " | ".join(printed))
        if rc != 0:
            raise AssertionError(f"cli serve returned {rc}")
        summary = json.loads(printed[-1])
        csv_path = os.path.join(root, "results", "mimic_cxr", "serve", "v1",
                                "serve_prediction.csv")
        import csv

        with open(csv_path, newline="") as f:
            rows = list(csv.reader(f))
    want_ids = sorted(e.id for e in has_ind + no_ind)
    if rows[0] != ["images_id", "generated_reports", "ground_truth"]             or sorted(r[0] for r in rows[1:]) != want_ids:
        raise AssertionError(f"cli csv: {len(rows) - 1} rows for {len(want_ids)} studies")
    if not all(r[1].strip() for r in rows[1:]):
        raise AssertionError("cli csv: empty report")
    if n_k2 <= 0 or n_k1 != 3 * n_k2:
        raise AssertionError(f"cli launch counts: lineage {n_k1}, fused {n_k2} "
                             "(want 3:1, > 0)")
    p50 = [s["batch_latency_p50_s"] for s in stats]
    out = dict(reports=summary["reports"], reports_per_s=summary["reports_per_s"],
               serve_wall_s=summary["wall_s"], batch_latency_p50_s=p50,
               batches=[s["batches"] for s in stats], peak_mem_gib=peak_gib,
               cli_wall_s=wall, launches_lineage=n_k1, launches_fused=n_k2,
               launches_fusion_attention=n_k3)
    log(f"cli serve: {summary['reports']} reports, reports_per_s="
        f"{summary['reports_per_s']} (serve wall {summary['wall_s']} s; with/without "
        f"indication batch_latency_p50_s={[round(x, 4) for x in p50]}), cli wall "
        f"{wall:.1f}s, peak_mem_gib={peak_gib:.2f}, launches lineage={n_k1} fused={n_k2} "
        f"fusion_attention={n_k3}")
    return out


def profile_serving(server, batches, top=15):
    """One served batch under torch.profiler: device busy share of the window
    (sum of kernel times over wall time; the profiler's own host cost lengthens
    the wall) and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.serve(batches, with_indication=True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kern)
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / wall_us, "kernel_launches": sum(e.count for e in kern),
           "top": [{"name": e.key[:90], "count": e.count,
                    "device_ms": e.self_device_time_total / 1e3} for e in kern[:top]],
           "ported": {}}
    for frag in PORTED_KERNELS:   # each hand-written kernel, wherever it ranks
        hits = [e for e in kern if frag in e.key]
        out["ported"][frag] = {"count": sum(e.count for e in hits),
                               "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}
        if out["ported"][frag]["count"] <= 0:
            raise AssertionError(f"profile: no launch of a kernel named *{frag}* in the "
                                 "served batch")
    log(f"profile (1 batch): wall_ms={out['wall_ms']:.1f} device_busy_ms="
        f"{out['device_busy_ms']:.1f} busy_share={out['busy_share']:.3f} "
        f"kernel_launches={out['kernel_launches']}")
    for t in out["top"]:
        log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
    for frag, t in out["ported"].items():
        log(f"  ported {frag}: {t['device_ms']:.3f} ms x{t['count']}")
    return out


def synthetic_tokenizer(vocab_size=30000):
    from evoke_tpu_torch.data.tokenizer import SPECIAL_TOKENS, WordTokenizer

    vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
    for i in range(vocab_size - len(vocab) - 2):   # [BOS], [EOS] are appended
        vocab[f"w{i}"] = len(vocab)
    tok = WordTokenizer(vocab)
    assert tok.get_vocab_size() == vocab_size
    return tok


def flagship(vocab_size, dtype, dev, seed):
    """__graft_entry__._flagship(vocab_size) at full width, seeded random weights."""
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.params import init_params_

    with torch.device(dev):
        model = FinetuneModel(vocab_size=vocab_size, max_seq_len=100, fusion_max_partners=3,
                              dtype=dtype)
    return init_params_(model, seed).eval()


def example_batch(rng, n_anchor, n_aux, image_size, seq_len, vocab_size):
    """The __graft_entry__._example_batch layout: anchors first, then aux views."""
    total = n_anchor + n_aux
    pids = np.concatenate([np.arange(n_anchor), np.arange(n_aux) % n_anchor]).astype(np.int32)
    return {
        "images": rng.standard_normal((total, image_size, image_size, 3), np.float32),
        "ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "mask": np.ones((n_anchor, seq_len), np.int32),
        "pids": pids,
        "valid": np.ones(total, bool),
        "inc_ids": rng.integers(5, vocab_size - 3, size=(n_anchor, seq_len)).astype(np.int32),
        "inc_mask": np.ones((n_anchor, seq_len), np.int32),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="", help="also write the results as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, serve one more batch under torch.profiler "
                         "and print device busy share, the top kernels and each "
                         "hand-written kernel's total")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        sys.exit(2)

    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.ops import _build
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import launch_plan as lineage_plan
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.serve import ReportServer
    from evoke_tpu_torch.train.steps import make_generate_step

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 2: build, compare, time ----
    t0 = time.perf_counter()
    built = _build.build_all(["lineage_attention", "fused_logit_topk", "fusion_attention"])
    log(f"build: {', '.join(p.name for p in built.values())} in "
        f"{time.perf_counter() - t0:.1f}s")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)  # > 50 MB L2
    k1 = {}
    for dtype in (torch.bfloat16, torch.float32):
        for lmax in (13, 100):
            for ring in (False, True):
                k1[(dtype, lmax, ring)] = check_lineage(dev, flush, g, dtype, lmax, ring)
    k1_converged = check_lineage(dev, flush, g, torch.bfloat16, 100, False, "converged")
    k1_by_length = lineage_schedule_times(dev, flush, g)
    k1_ptxas = ptxas_report(f"{built['lineage_attention']}.log", ("lineage_kernel",))
    log_ptxas({name: rec for name, rec in k1_ptxas.items() if ", 64, 3>" in name})
    serving_regs = k1_ptxas.get("lineage_kernel<bf16, 64, 3>", {}).get("registers")
    if not serving_regs:
        raise AssertionError("no lineage_kernel<bf16, 64, 3> entry in the -Xptxas -v log")
    k1_plan = lineage_plan(3, 100, 64, torch.bfloat16)
    k1_plan["blocks_per_sm_by_registers"] = 65536 // (serving_regs * k1_plan["threads"])
    log(f"K1 bf16 plan L=100: {k1_plan['threads']} threads, {k1_plan['lanes_per_row']} lanes "
        f"a row, {k1_plan['rows_in_flight']} rows in flight a warp, V tile "
        f"{k1_plan['v_rows']} rows; {k1_plan['smem_bytes']} B dynamic smem (V "
        f"{k1_plan['v_bytes']}, scores {k1_plan['score_bytes']}, list "
        f"{k1_plan['list_bytes']}, partials {k1_plan['part_bytes']}); blocks per SM "
        f"{k1_plan['blocks_per_sm']} by shared memory, "
        f"{k1_plan['blocks_per_sm_by_registers']} by registers")
    k2 = {}
    for dtype, n in ((torch.bfloat16, 192), (torch.bfloat16, 96), (torch.float32, 192)):
        for suppress in ((), (4,)):
            k2[(dtype, suppress, n)] = check_fused_topk(dev, flush, g, dtype, suppress, n)
    k2_ptxas = ptxas_report(f"{built['fused_logit_topk']}.log",
                            ("tile_kernel_bf16", "merge_kernel_warp"))
    log_ptxas(k2_ptxas)
    for n in (192, 96):
        plan = k2[(torch.bfloat16, (4,), n)]["plan"]
        log(f"K2 bf16 plan N={n}: {plan['tiles']} tiles on {plan['grid']} blocks of "
            f"{plan['threads']} threads, {plan['stages']} stages, {plan['smem_bytes']} B "
            f"dynamic smem")
    if not any(name.startswith("tile_kernel_bf16") for name in k2_ptxas):
        raise AssertionError("no tile_kernel_bf16 entry in the -Xptxas -v log")
    k3 = {}
    for n_anchor in (32, 64):
        for dtype in (torch.bfloat16, torch.float32):
            k3[(dtype, n_anchor)] = check_fusion_attention(
                dev, flush, g, dtype, n_anchor, library=dtype == torch.bfloat16)
            torch.cuda.empty_cache()
    del flush

    # ---- phase 3: small-input reference check at float32 ----
    tok = synthetic_tokenizer(30000)
    vocab = tok.get_vocab_size()
    cfg = DecodeConfig(beam_size=3, suppress_unk=True)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    model32 = flagship(vocab, torch.float32, dev, args.seed)
    small = {k: torch.as_tensor(v).to(dev) for k, v in
             example_batch(rng, 2, 2, 224, 100, vocab).items()}
    serve_gen = make_generate_step(model32, tok, cfg, 100, with_indication=True,
                                   serving=True, device=dev)
    eval_gen = make_generate_step(model32, tok, cfg, 100, with_indication=True,
                                  serving=False, device=dev)
    assert serve_gen.ancestor_kv and serve_gen.fused_topk
    assert not eval_gen.ancestor_kv and not eval_gen.fused_topk
    s_kern = serve_gen(small).cpu().numpy()
    s_plain = eval_gen(small).cpu().numpy()
    agree = float((s_kern == s_plain).mean())
    log(f"reference check (float32, 2 studies, kernels vs reorder + plain tail): "
        f"token agreement {agree:.4f}, {time.perf_counter() - t0:.1f}s")
    if agree < 0.9:
        raise AssertionError(f"serving path disagrees with the eval path: {agree}")
    del model32, serve_gen, eval_gen
    torch.cuda.empty_cache()

    # ---- phase 4: the main path ----
    t0 = time.perf_counter()
    model = flagship(vocab, torch.bfloat16, dev, args.seed)
    batches = []
    for i in range(3):
        bt = example_batch(rng, 64, 64, 224, 100, vocab)
        bt["_image_ids"] = [f"b{i}_s{j}" for j in range(64)]
        batches.append(bt)
    # depth 0: the beam loop already syncs once per step (early stop), so
    # holding finished batches back adds latency and no throughput
    server = ReportServer(model, tok, cfg, max_seq_len=100, depth=0, device=dev)
    server.serve(batches[:1], with_indication=True)          # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    log(f"main path set-up (model, data, warm-up batch) {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    records = server.serve(batches, with_indication=True)
    torch.cuda.synchronize()
    n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    st = server.stats
    if len(records) != 192 or len({r["id"] for r in records}) != 192:
        raise AssertionError(f"expected 192 records, got {len(records)}")
    if not all(r["report"].strip() for r in records):
        raise AssertionError("empty report")
    words = sum(len(r["report"].split()) for r in records)
    if n_k2 <= 0 or n_k1 != 3 * n_k2:
        raise AssertionError(f"launch counts: lineage {n_k1}, fused {n_k2} (want 3:1, > 0)")
    log(f"main path: {len(records)} reports ({words} words, non-PAD), "
        f"reports_per_s={st['reports_per_s']:.2f} batch_latency_p50_s="
        f"{st['batch_latency_p50_s']:.4f} wall_s={st['wall_s']:.3f} peak_mem_gib="
        f"{peak_gib:.2f} decode_steps={n_k2} launches lineage={n_k1} fused={n_k2}")

    profile = profile_serving(server, batches[:1]) if args.profile else None
    del model, server, batches
    torch.cuda.empty_cache()

    # ---- phase 5: the fusion module through K3 ----
    t0 = time.perf_counter()
    n_k3, fusion_errs = check_fusion_module(dev, args.seed)
    log(f"fusion module phase: launches fusion_attention={n_k3}, "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- phase 6: the serve CLI ----
    cli_res = serve_cli(args.seed)

    line_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main1, main2, main3 = ({key: rec[key] for key in line_keys} for rec in (
        k1[(torch.bfloat16, 100, False)], k2[(torch.bfloat16, (4,), 192)],
        k3[(torch.bfloat16, 64)]))
    kernels = {"kernels": [
        dict(name="lineage_attention", route="cuda",
             source="evoke_tpu_torch/csrc/lineage_attention.cu",
             replaces="evoke_tpu/ops/lineage_attention.py:213", launches=n_k1, **main1),
        dict(name="fused_logit_topk", route="cuda",
             source="evoke_tpu_torch/csrc/fused_logit_topk.cu",
             replaces="evoke_tpu/ops/fused_logit_topk.py:147", launches=n_k2, **main2),
        dict(name="masked_cross_view_attention", route="cuda",
             source="evoke_tpu_torch/csrc/fusion_attention.cu",
             replaces="evoke_tpu/ops/fusion_attention.py:86", launches=n_k3, **main3),
    ]}
    if args.out:
        detail = {
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "lineage_attention": {f"{str(k[0])[6:]}_L{k[1]}_{'ring' if k[2] else 'batch'}": v
                                  for k, v in k1.items()},
            "lineage_attention_converged": k1_converged,
            "lineage_attention_by_length": k1_by_length,
            "lineage_attention_ptxas": k1_ptxas, "lineage_attention_plan": k1_plan,
            "fused_logit_topk": {f"{str(k[0])[6:]}_N{k[2]}_sup{len(k[1])}": v
                                 for k, v in k2.items()},
            "fused_logit_topk_ptxas": k2_ptxas,
            "fusion_attention": {f"{str(k[0])[6:]}_Q{k[1]}": v for k, v in k3.items()},
            "fusion_module": dict(fusion_errs, launches_fusion_attention=n_k3),
            "cli_serve": cli_res,
            "main_path": dict(st, peak_mem_gib=peak_gib, launches_lineage=n_k1,
                              launches_fused=n_k2, reference_token_agreement=agree),
            "kernels": kernels["kernels"], "profile": profile,
            "total_s": time.perf_counter() - t_start,
        }
        with open(args.out, "w") as f:
            json.dump(detail, f, indent=1)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
