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
   them, with anchors of 0 (self slot), 1 and 3 partners; at bf16 kernel and
   SDPA are timed in turns both ways; its wrapper's host time, its launch
   plan and its registers and spills from the -Xptxas -v log are printed, and
   a missing or spilling serving template fails the run;
3. a correctness check on a small input: the full-width flagship at float32
   decodes two studies three ways: through the serving path (lineage kernel +
   fused tail) with the decode steps replayed from CUDA graphs, through the
   same path run eagerly (``graphs=False``), and through the eval path
   (reorder caches, plain vocab tail). Captured and eager must give the same
   tokens and the same scores, bit for bit (same kernels, same order); the
   best beams of the serving and eval paths must agree (float32: the attended
   sets are identical). Then an early-stop check: a full-width one-layer
   float32 R2Gen decoder (64 samples x beam 3, serving schedule, 'wu_0.8')
   whose EOS logit bias is raised at step 15, so every beam finishes in the
   second cache phase; captured and eager must agree in tokens and scores,
   and the steps queued (one phase's end, below max_len) are printed beside
   the steps a read per step would have run, with the cost of one flag read;
4. the main path: the full-width flagship (ResNet-101 @ 224, wide-qkv
   grouped fusion, 768x6 text encoder + BertCrossLayer, R2Gen decoder d 512,
   30001 logits, bf16) with seeded random weights serves 3 batches of 64
   studies (64 anchors + 64 aux views, with indication) through ReportServer
   at beam 3 and depth 2, four times in one process: eager, captured,
   captured, eager. Each run prints reports/s, p50 batch latency, peak GiB
   and its launch counts; wall per decode step (the loop alone, between two
   synchronisations), capture seconds and the loop's device memory are
   printed for each mode. Every launch counter is set to 0 just before each
   run and read just after, and each kernel must have been launched (K1
   three times per step), replayed graphs included; ``--profile`` serves one
   more captured batch under torch.profiler;
5. the fusion module at full width (d_vf 2048, wide qkv, 8 heads, T 50, the
   flagship layout): BatchedCrossViewAttention(use_pallas=True) against the
   dense route and the grouped route (max_partners=3) with one weight set, at
   float32 and bf16; K3's count is set to 0 before and must rise;
6. the serve CLI in-process at full width and every CLI default but bf16
   (ResNet-101 @ 224, dense fusion, 768x6 encoder, R2Gen 512x3, beam 3, batch
   32 + 32 aux, uint8 images) over a synthetic dataset written to a temporary
   directory with a 30000-word tokenizer, decode steps captured; one
   non-empty report per test study, K1:K2 launches 3:1, reports/s with and
   without the capture time;
7. the test CLI in-process over phase 6's dataset and configuration, with a
   BERT-base-width CheXbert checkpoint written to the temporary directory
   (HF key names, 'module.' prefix, seeded weights, a 30522-entry vocab):
   beam 3 on the eval path (reorder caches, one cache phase, the plain vocab
   tail: K1 and K2 launch 0 times), captured; test_prediction.csv must hold
   the 11 metric rows first (BLEU 1-4, METEOR, ROUGE_L, CIDEr and four
   CheXbert F1s; no degraded metric), each finite and in range, then one
   non-empty row per study; the score CLI on that file must print the same
   NLG values; the labeler's float32 logits on the card must match the same
   module on the CPU for 8 reports within ``CHEXBERT_TOL``. Prints the test
   wall with and without the capture, decode reports/s, the host seconds
   in compute_nlg_scores, CheXbert's device seconds (CUDA events) and
   reports/s, and peak GiB, beside the card's name and power limit;
8. a JSON line of every ported kernel, then the result line.

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
import tempfile
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
    from evoke_tpu_torch.ops.fusion_attention import (launch_plan, masked_cross_view_attention,
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
    lib_ms = dev_lib_ms = None
    backend = "not timed"
    if library:
        # library yardstick: SDPA, boolean [Q, 1, 1, N] mask, k/v expanded to Q;
        # kernel and SDPA timed in turns (library, kernel, kernel, library), both ways
        mask = attend.repeat_interleave(t, dim=1)[:, None, None, :]
        ke, ve = k[None].expand(n_anchor, h, n, dk), v[None].expand(n_anchor, h, n, dk)
        backend = sdpa_backend(q, ke, ve, mask)
        sdpa = functools.partial(F.scaled_dot_product_attention, q, ke, ve, attn_mask=mask)
        ms, lib_ms = time_in_turns(kernel, sdpa, flush, reps=5)
        dev_ms, dev_lib_ms = time_in_turns(kernel, sdpa, flush, reps=5, device_only=True)
        del mask, ke, ve, sdpa
    else:
        ms = time_ms(kernel, flush, reps=10)
        dev_ms = time_ms(kernel, flush, reps=10, device_only=True)
    wrapper_us = host_us(kernel, calls=200)
    plain_ms = time_ms(lambda: masked_cross_view_attention_plain(q, k, v, attend, t), flush,
                       reps=5)
    # this data's work: q, out and mask once, the K/V rows of every sample some
    # anchor attends once; QK and PV over each anchor's attended samples only
    isz = q.element_size()
    rows = int(attend_np.any(axis=0).sum()) * t
    nbytes = 2 * q.numel() * isz + 2 * rows * h * dk * isz + attend_np.size
    flops = 4 * t * t * dk * h * int(attend_np.sum())
    bms, by = bound_ms(nbytes, flops, dtype)
    fmt = lambda x: "not timed" if x is None else f"{x:.4f}"
    log(f"kernel fusion_attention Q={n_anchor} B={b} T={t} h={h} dk={dk} "
        f"{str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={fmt(lib_ms)} (backend {backend}) "
        f"bound_ms={bms:.4f} ({by}); device-only ms={dev_ms:.4f} sdpa_ms={fmt(dev_lib_ms)}; "
        f"wrapper host {wrapper_us:.1f} us/call")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, device_only_ms=dev_ms, device_only_library_ms=dev_lib_ms,
                wrapper_host_us=wrapper_us, sdpa_backend=backend,
                plan=launch_plan(t, dk, dtype))


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


def write_cli_dataset(root, seed):
    """Phase 6's and 7's data in ``root``: a synthetic dataset (224 px .npy,
    160 test studies) and a 30000-word tokenizer where build_tokenizer looks.
    Returns (annotation path, tokenizer dir, test studies with indication,
    without)."""
    import os

    from evoke_tpu_torch.data.datasets import load_annotation, parse_finetune
    from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
    from evoke_tpu_torch.data.tokenizer import WordTokenizer

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
    return ann, tok_dir, has_ind, no_ind


def serve_cli(root, ann, tok_dir, has_ind, no_ind):
    """The serve CLI in-process at full width over the synthetic dataset:
    every CLI default but bf16. Returns the phase's numbers."""
    import contextlib
    import csv
    import io
    import os

    from evoke_tpu_torch import cli, serve
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

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
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    want_ids = sorted(e.id for e in has_ind + no_ind)
    if rows[0] != ["images_id", "generated_reports", "ground_truth"] \
            or sorted(r[0] for r in rows[1:]) != want_ids:
        raise AssertionError(f"cli csv: {len(rows) - 1} rows for {len(want_ids)} studies")
    if not all(r[1].strip() for r in rows[1:]):
        raise AssertionError("cli csv: empty report")
    if n_k2 <= 0 or n_k1 != 3 * n_k2:
        raise AssertionError(f"cli launch counts: lineage {n_k1}, fused {n_k2} "
                             "(want 3:1, > 0)")
    p50 = [s["batch_latency_p50_s"] for s in stats]
    capture_s = sum(s["capture_s"] for s in stats)
    if capture_s <= 0:
        raise AssertionError("cli serve: the decode steps were not captured")
    served_s = sum(s["wall_s"] for s in stats) - capture_s
    out = dict(reports=summary["reports"], reports_per_s=summary["reports_per_s"],
               capture_s=capture_s, reports_per_s_without_capture=summary["reports"] / served_s,
               serve_wall_s=summary["wall_s"], batch_latency_p50_s=p50,
               batches=[s["batches"] for s in stats], peak_mem_gib=peak_gib,
               cli_wall_s=wall, launches_lineage=n_k1, launches_fused=n_k2,
               launches_fusion_attention=n_k3)
    log(f"cli serve: {summary['reports']} reports, reports_per_s="
        f"{summary['reports_per_s']} with the capture of the decode steps "
        f"({capture_s:.2f}s for {len(stats)} loops), "
        f"{out['reports_per_s_without_capture']:.3f} without (serve wall "
        f"{summary['wall_s']} s; with/without "
        f"indication batch_latency_p50_s={[round(x, 4) for x in p50]}), cli wall "
        f"{wall:.1f}s, peak_mem_gib={peak_gib:.2f}, launches lineage={n_k1} fused={n_k2} "
        f"fusion_attention={n_k3}")
    return out


CHEXBERT_SHAPE = dict(hidden=768, layers=12, intermediate=3072, positions=512, vocab=30522)
# CheXbert logits, card against CPU, float32 with TF32 off: the two devices sum
# 12 layers of float32 products over 768 / 3072 in other orders
CHEXBERT_TOL = 1e-4
METRIC_ROWS = ("BLEU_1", "BLEU_2", "BLEU_3", "BLEU_4", "METEOR", "ROUGE_L", "CIDer",
               "chexbert_5_micro_f1", "chexbert_all_micro_f1", "chexbert_5_macro_f1",
               "chexbert_all_macro_f1")


def write_chexbert_checkpoint(directory, words, dev, seed):
    """A BERT-base-width CheXbert checkpoint in ``directory``, as the real
    ``chexbert.pth`` lays it out: {'model_state_dict': {'module.bert.<HF
    BertModel key>', 'module.linear_heads.<i>.*'}}, pooler and position ids
    included; matrices and biases N(0, 0.02) from a seeded torch.Generator,
    LayerNorm scales 1. Beside it a 30522-entry WordPiece vocab.txt in the
    bert-base-uncased layout ([PAD], 99 [unused], [UNK] [CLS] [SEP] [MASK],
    then ``words``, then filler). Returns the checkpoint's path."""
    import os

    c = CHEXBERT_SHAPE
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(words) + ["##s", "##es"])
    vocab += [f"x{i}" for i in range(c["vocab"] - len(vocab))]
    assert len(vocab) == c["vocab"] == len(set(vocab))
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    h, ff = c["hidden"], c["intermediate"]
    shapes = {"embeddings.word_embeddings.weight": (c["vocab"], h),
              "embeddings.position_embeddings.weight": (c["positions"], h),
              "embeddings.token_type_embeddings.weight": (2, h),
              "embeddings.LayerNorm.weight": (h,), "embeddings.LayerNorm.bias": (h,)}
    for i in range(c["layers"]):
        pre = f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            shapes[pre + name + ".weight"], shapes[pre + name + ".bias"] = (h, h), (h,)
        shapes[pre + "intermediate.dense.weight"] = (ff, h)
        shapes[pre + "intermediate.dense.bias"] = (ff,)
        shapes[pre + "output.dense.weight"], shapes[pre + "output.dense.bias"] = (h, ff), (h,)
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            shapes[pre + ln + ".weight"], shapes[pre + ln + ".bias"] = (h,), (h,)
    shapes["pooler.dense.weight"], shapes["pooler.dense.bias"] = (h, h), (h,)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    sd = {}
    for key, shape in shapes.items():
        if key.endswith("LayerNorm.weight"):
            sd["module.bert." + key] = torch.ones(shape)
        else:
            sd["module.bert." + key] = (torch.randn(shape, generator=g, device=dev)
                                        * 0.02).cpu()
    sd["module.bert.embeddings.position_ids"] = torch.arange(c["positions"])[None]
    for i in range(14):
        n = 4 if i < 13 else 2
        sd[f"module.linear_heads.{i}.weight"] = (torch.randn(n, h, generator=g, device=dev)
                                                 * 0.02).cpu()
        sd[f"module.linear_heads.{i}.bias"] = (torch.randn(n, generator=g, device=dev)
                                               * 0.02).cpu()
    path = os.path.join(directory, "chexbert.pth")
    torch.save({"model_state_dict": sd}, path)
    return path


def test_cli(root, ann, tok_dir, has_ind, no_ind, smi, seed):
    """The test CLI in-process at full width over phase 6's dataset (every CLI
    default but bf16; beam 3 on the eval path, captured) with a BERT-base
    CheXbert the phase writes; then the score CLI on its test_prediction.csv, and
    the labeler's float32 logits on the card against the same module on the
    CPU. Returns the phase's numbers."""
    import contextlib
    import copy
    import csv
    import gc
    import io
    import os

    from evoke_tpu_torch import cli
    from evoke_tpu_torch.data.tokenizer import WordTokenizer
    from evoke_tpu_torch.evals import chexbert, composite
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.train import trainer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chex_dir = os.path.join(root, "chexbert")
    os.makedirs(chex_dir)
    words = sorted(w for w in WordTokenizer.from_file(os.path.join(
        tok_dir, "mimic_cxr_wordlevel_uncased_tokenizer.json")).vocab if not w.startswith("["))
    ck = write_chexbert_checkpoint(chex_dir, words, torch.device("cuda"), seed + 3)
    log(f"chexbert checkpoint: BERT-base ({os.path.getsize(ck) / 2 ** 20:.0f} MiB) written "
        f"in {time.perf_counter() - t0:.1f}s")

    testers, nlg_s, label_s, label_n, fwd_events = [], [], [], [], []
    test_fn, nlg_fn = trainer.Tester.test, composite.compute_nlg_scores
    label_fn, fwd_fn = chexbert.F1CheXbert.label, chexbert.ChexbertLabeler.forward

    def recording_test(self):
        testers.append(self)
        return test_fn(self)

    def timed_nlg(*a):
        t = time.perf_counter()
        out = nlg_fn(*a)
        nlg_s.append(time.perf_counter() - t)
        return out

    def timed_label(self, reports):
        t = time.perf_counter()
        out = label_fn(self, reports)
        label_s.append(time.perf_counter() - t)
        label_n.append(len(reports))
        return out

    def timed_forward(self, *a):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fwd_fn(self, *a)
        e.record()
        fwd_events.append((s, e))
        return out

    trainer.Tester.test, composite.compute_nlg_scores = recording_test, timed_nlg
    chexbert.F1CheXbert.label, chexbert.ChexbertLabeler.forward = timed_label, timed_forward
    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    masked_cross_view_attention.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["test", "--data.ann_path", ann, "--data.image_dir", root,
                           "--data.tokenizer_dir", tok_dir,
                           "--trainer.result_dir", os.path.join(root, "results"),
                           "--model.dtype", "bfloat16", "--metrics.chexbert_checkpoint", ck])
        torch.cuda.synchronize()
    finally:
        trainer.Tester.test, composite.compute_nlg_scores = test_fn, nlg_fn
        chexbert.F1CheXbert.label, chexbert.ChexbertLabeler.forward = label_fn, fwd_fn
    wall = time.perf_counter() - t0
    n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
    n_k3 = masked_cross_view_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log("cli test stdout (last lines): " + " | ".join(buf.getvalue().strip().splitlines()[-4:]))
    if rc != 0:
        raise AssertionError(f"cli test returned {rc}")
    (tester,) = testers
    stats = dict(tester.stats)
    loops = [loop for g in (tester.gen_inc, tester.gen_noinc) for loop, _ in g.loops.values()]
    del testers, tester
    csv_path = os.path.join(root, "results", "mimic_cxr", "test", "v1", "test_prediction.csv")
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))

    # ---- checks ----
    k = len(METRIC_ROWS)
    if rows[0] != ["images_id", "ground_truth", "pred_test"] \
            or tuple(r[1] for r in rows[1:k + 1]) != METRIC_ROWS \
            or any(not r[0].startswith("__metric__") for r in rows[1:k + 1]) \
            or any(r[0].startswith("__metric__") for r in rows[k + 1:]):
        raise AssertionError(f"cli test csv: metric rows {[r[0] for r in rows[1:k + 2]]}, "
                             f"want {METRIC_ROWS} first and nothing else (no degraded_metrics)")
    metrics = {r[1]: float(r[2]) for r in rows[1:k + 1]}
    for name, v in metrics.items():
        hi = 10.0 if name == "CIDer" else 1.0
        if not (math.isfinite(v) and 0.0 <= v <= hi):
            raise AssertionError(f"cli test: {name} = {v}, outside [0, {hi}]")
    want_ids = sorted(e.id for e in has_ind + no_ind)
    if sorted(r[0] for r in rows[k + 1:]) != want_ids or not all(
            r[1].strip() and r[2].strip() for r in rows[k + 1:]):
        raise AssertionError(f"cli test csv: {len(rows) - 1 - k} study rows for "
                             f"{len(want_ids)} studies, or an empty cell")
    if n_k1 or n_k2 or n_k3:
        raise AssertionError(f"cli test launch counts: lineage {n_k1}, fused {n_k2}, fusion "
                             f"{n_k3} (the eval path launches none)")
    if not (loops and all(loop.graphs for loop in loops) and stats["capture_s"] > 0):
        raise AssertionError("cli test: the eval path's decode steps were not captured")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["score", "--data.ann_path", csv_path])
    scored = json.loads(buf.getvalue())
    if rc != 0 or scored != {n: metrics[n] for n in METRIC_ROWS[:7]}:
        raise AssertionError(f"cli score {scored} != the csv's metric rows {metrics}")
    (scorer,) = composite._SCORER_CACHE.values()
    encoder_tensors = 5 + 16 * CHEXBERT_SHAPE["layers"]
    if scorer.import_report != {"loaded": encoder_tensors, "mismatched": 0, "missing": 0}:
        raise AssertionError(f"chexbert import: {scorer.import_report}")
    reports = [r[1] for r in rows[k + 1:k + 5]] + [r[2] for r in rows[k + 1:k + 5]]
    ids = np.stack([scorer._encode(r) for r in reports])
    ids = ids[:, :int((ids != scorer.tokenizer.pad_id).sum(1).max())]
    mask = (ids != scorer.tokenizer.pad_id).astype(np.int32)
    cpu_model = copy.deepcopy(scorer.model).cpu()
    with torch.inference_mode():
        card = torch.cat(scorer.model(torch.as_tensor(ids, device=scorer.device),
                                      torch.as_tensor(mask, device=scorer.device)), 1).cpu()
        host = torch.cat(cpu_model(torch.as_tensor(ids), torch.as_tensor(mask)), 1)
    chex_err = (card - host).abs().max().item()
    if not chex_err <= CHEXBERT_TOL:
        raise AssertionError(f"chexbert logits card vs cpu: max abs err {chex_err} > "
                             f"{CHEXBERT_TOL}")
    chex_batch = f"{scorer.batch_size} x {scorer.max_len}"
    del cpu_model, scorer
    composite._SCORER_CACHE.clear()

    # ---- numbers ----
    chex_dev_s = sum(s.elapsed_time(e) for s, e in fwd_events) / 1e3
    out = dict(cli_wall_s=wall, cli_wall_s_without_capture=wall - stats["capture_s"],
               capture_s=stats["capture_s"], reports=int(stats["reports"]),
               decode_s=stats["decode_s"],
               decode_reports_per_s=stats["reports"] / (stats["decode_s"] - stats["capture_s"]),
               metrics_s=stats["metrics_s"], nlg_s=sum(nlg_s),
               chexbert_label_s=sum(label_s), chexbert_reports=sum(label_n),
               chexbert_batches=len(fwd_events), chexbert_device_s=chex_dev_s,
               chexbert_reports_per_s_device=sum(label_n) / chex_dev_s,
               chexbert_logits_max_abs_err=chex_err, peak_mem_gib=peak_gib,
               launches_lineage=n_k1, launches_fused=n_k2, launches_fusion_attention=n_k3,
               metrics=metrics, device=smi)
    log(f"cli test [{smi}]: {out['reports']} reports + {k} metric rows; cli wall "
        f"{wall:.2f}s with the capture of the decode steps ({stats['capture_s']:.2f}s, "
        f"{len(loops)} loops), {out['cli_wall_s_without_capture']:.2f}s without; decode "
        f"{out['decode_reports_per_s']:.2f} reports/s without the capture (decode wall "
        f"{stats['decode_s']:.2f}s); metrics {stats['metrics_s']:.2f}s, of which "
        f"compute_nlg_scores {out['nlg_s']:.3f}s (host)")
    log(f"cli test chexbert [{smi}]: {out['chexbert_reports']} reports in "
        f"{len(fwd_events)} batches of {chex_batch}, device {chex_dev_s:.3f}s by CUDA events "
        f"({out['chexbert_reports_per_s_device']:.1f} reports/s), label() wall "
        f"{out['chexbert_label_s']:.3f}s ({sum(label_n) / sum(label_s):.1f} reports/s); "
        f"logits card vs cpu max abs err {chex_err:.3e} (tol {CHEXBERT_TOL}, 8 reports, "
        f"float32); peak_mem_gib={peak_gib:.2f}; launches lineage={n_k1} fused={n_k2} "
        f"fusion_attention={n_k3}; metrics "
        + " ".join(f"{n}={v:.4f}" for n, v in metrics.items()))
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


def only_loop(gen):
    """The one BeamLoop a generate step has built (one batch shape so far)."""
    (loop, _), = gen.loops.values()
    return loop


def decode_step_wall_ms(gen, dev_batch, reps=3):
    """Wall milliseconds per decode step: ``BeamLoop.run`` alone on the host
    clock between two device synchronisations, the median of ``reps``
    batches. Returns (ms per step, steps per batch)."""
    from evoke_tpu_torch.decode.beam import BeamLoop

    run, seen = BeamLoop.run, []

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self)
        torch.cuda.synchronize()
        seen.append(((time.perf_counter() - t0) * 1e3 / self.steps_run, self.steps_run))
        return out

    BeamLoop.run = timed
    try:
        for _ in range(reps):
            gen(dev_batch)
    finally:
        BeamLoop.run = run
    return statistics.median(ms for ms, _ in seen), seen[0][1]


def check_early_stop(dev, seed):
    """Early stop on the card under a non-identity length penalty: a
    full-width one-layer float32 R2Gen decoder, 64 samples x beam 3, the
    serving policy (ancestor caches, 8 cache phases, fused tail), 'wu_0.8'.
    The step sets the EOS logit bias to -50 at step 0 and to +50 at step 15,
    so every beam finishes at step 15, in the second phase [13, 25). The
    captured loop and the eager loop must return the same tokens and scores
    and leave at the phase's end."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.decode.beam import BeamLoop
    from evoke_tpu_torch.models.rm_decoder import RMDecoder
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.steps import cache_schedule

    vocab, batch, beam, max_len, switch_at = 30000, 64, 3, 100, 15
    schedule = cache_schedule(DecodeConfig(beam_size=beam), max_len, serving=True)
    with torch.device(dev):
        dec = init_params_(RMDecoder(vocab_size=vocab, num_layers=1, max_seq_len=max_len,
                                     dtype=torch.float32), seed).eval()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    att = torch.randn(batch, 49, 2048, generator=g, device=dev)
    mask = torch.ones(batch, 49, dtype=torch.int32, device=dev)
    bos, eos = vocab - 2, vocab - 1      # the tokenizer's last two ids; vocab + 1 logits
    with torch.inference_mode():
        lo, hi = dec.logit.bias.clone(), dec.logit.bias.clone()
        lo[eos] -= 50.0
        hi[eos] += 50.0
        state0 = dec.init_decode_state(dec.encode(att, mask), batch * beam, schedule[0])

    def step(tok, t, st):
        if t in (0, switch_at):
            dec.logit.bias.copy_(hi if t else lo)
        return dec.decode_step(tok, t, st, mask, return_topk=beam, topk_suppress=(4,))

    out = {}
    for name, graphs in (("captured", True), ("eager", False)):
        loop = BeamLoop(step, state0, batch, bos_id=bos, eos_id=eos, pad_id=0,
                        vocab_size=vocab + 1, beam_size=beam, max_len=max_len,
                        length_penalty="wu_0.8", raw_logits=True, fused_topk=True,
                        ancestor_kv=True, cache_schedule=schedule, early_stop=True,
                        graphs=graphs)
        loop.load(state0)
        res = loop.run()
        out[name] = dict(res=res, steps=loop.steps_run, live=int(loop.live_steps),
                         reads=loop.flag_reads, capture_s=loop.capture_s,
                         read_us=host_us(loop.all_finished, calls=50))
        del loop
    cap, eag = out["captured"], out["eager"]
    same_tok = torch.equal(cap["res"].seqs, eag["res"].seqs)
    same_score = torch.equal(cap["res"].scores, eag["res"].scores)
    ended = bool((cap["res"].seqs == eos).any(-1).all())
    log(f"early stop (float32, 1 layer, 64 x beam 3, wu_0.8, EOS raised at step "
        f"{switch_at}, schedule {schedule}): captured queued {cap['steps']} steps with "
        f"{cap['reads']} flag reads, eager {eag['steps']} with {eag['reads']}; a read per "
        f"step would have run {cap['live']}; tokens equal {same_tok}, scores equal "
        f"{same_score}; one flag read on an idle device {cap['read_us']:.1f} us "
        f"(captured) / {eag['read_us']:.1f} us (eager); capture {cap['capture_s']:.2f}s")
    phase_len = max(b - a for a, b in zip((0,) + schedule, schedule))
    if not (same_tok and same_score and ended):
        raise AssertionError("early stop: captured and eager loops disagree, or a "
                             "recorded beam never ended")
    if not (cap["live"] == eag["live"] == switch_at + 1 and cap["steps"] < max_len
            and cap["steps"] <= eag["steps"] + phase_len and cap["steps"] == schedule[1]):
        raise AssertionError(f"early stop: steps {cap['steps']} / {eag['steps']}, live "
                             f"{cap['live']} / {eag['live']}")
    torch.cuda.empty_cache()
    return {k: {kk: vv for kk, vv in v.items() if kk != "res"} for k, v in out.items()}


def main_path(model, tok, cfg, batches, dev, with_profile):
    """Serve ``batches`` through ReportServer at depth 2 (the server's default:
    a captured loop reads nothing after its last cache phase, so a held
    batch's tail overlaps the next batch's encoder) four times in the order
    eager, captured, captured, eager. One server is alive at a time, so each
    run's peak memory is its own mode's; a server is warmed with one batch
    (cuDNN plans; the capture). After each run the decode loop alone is timed.
    Returns (runs, set-ups, wall ms per step by mode, the profile or None)."""
    import gc

    from evoke_tpu_torch.data.batching import to_device
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.serve import ReportServer

    dev_batch, _ = to_device(batches[0], dev)
    runs, set_up, step_wall, profile = [], [], {}, None
    server = loop = server_mode = None
    for i, mode in enumerate(("eager", "captured", "captured", "eager")):
        if mode != server_mode:
            server = loop = None               # frees the other mode's loop: buffers, graphs, pool
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved(),
                      torch.cuda.mem_get_info()[0])
            t0 = time.perf_counter()
            server = ReportServer(model, tok, cfg, max_seq_len=100, depth=2, device=dev,
                                  graphs=None if mode == "captured" else False)
            server.serve(batches[:1], with_indication=True)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
            loop = only_loop(server._gen[True])
            if loop.graphs != (mode == "captured"):
                raise AssertionError(f"main path: the {mode} server's loop has graphs="
                                     f"{loop.graphs}")
            gib = 2 ** 30
            rec = dict(mode=mode, warm_up_s=warm_s, capture_s=server.stats["capture_s"],
                       loop_static_gib=loop.static_bytes / gib,
                       allocated_kept_gib=(torch.cuda.memory_allocated() - before[0]) / gib,
                       reserved_kept_gib=(torch.cuda.memory_reserved() - before[1]) / gib,
                       device_kept_gib=(before[2] - torch.cuda.mem_get_info()[0]) / gib)
            set_up.append(rec)
            log(f"main path {mode} server: warm-up batch {warm_s:.2f}s of which capture "
                f"{rec['capture_s']:.2f}s ({len(loop._graphs)} graphs); kept after it: loop "
                f"buffers {rec['loop_static_gib']:.3f} GiB, tensors "
                f"{rec['allocated_kept_gib']:.3f} GiB, the allocator's segments (tensors, "
                f"graph pool) {rec['reserved_kept_gib']:.3f} GiB, device memory by the "
                f"cudaMemGetInfo's count {rec['device_kept_gib']:.3f} GiB")
            server_mode = mode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lineage_attention.launches = 0
        fused_logit_topk.launches = 0
        records = server.serve(batches, with_indication=True)
        torch.cuda.synchronize()
        n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
        run = dict(server.stats, mode=mode, launches_lineage=n_k1, launches_fused=n_k2,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   words=sum(len(r["report"].split()) for r in records))
        if len(records) != 192 or len({r["id"] for r in records}) != 192:
            raise AssertionError(f"{mode}: expected 192 records, got {len(records)}")
        if not all(r["report"].strip() for r in records):
            raise AssertionError(f"{mode}: empty report")
        if n_k2 <= 0 or n_k1 != 3 * n_k2:
            raise AssertionError(f"{mode} launch counts: lineage {n_k1}, fused {n_k2} "
                                 "(want 3:1, > 0)")
        if run["capture_s"] != 0.0:
            raise AssertionError(f"{mode}: a warmed server captured again")
        if runs and run["words"] != runs[0]["words"]:
            raise AssertionError(f"{mode}: {run['words']} words, the first run "
                                 f"{runs[0]['words']}")
        ms, steps = decode_step_wall_ms(server._gen[True], dev_batch)
        run["decode_step_wall_ms"] = ms
        step_wall.setdefault(mode, []).append(ms)
        log(f"main path {mode}: {len(records)} reports ({run['words']} words, non-PAD), "
            f"reports_per_s={run['reports_per_s']:.2f} batch_latency_p50_s="
            f"{run['batch_latency_p50_s']:.4f} wall_s={run['wall_s']:.3f} peak_mem_gib="
            f"{run['peak_mem_gib']:.2f} decode_steps={n_k2} launches lineage={n_k1} "
            f"fused={n_k2}; the decode loop alone {ms:.3f} ms of wall per step over "
            f"{steps} steps (median of 3 batches)")
        runs.append(run)
        if with_profile and i == 2:
            profile = profile_serving(server, batches[:1])
    return runs, set_up, step_wall, profile


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
    from evoke_tpu_torch.ops.lineage_attention import launch_plan as lineage_plan
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
    k3_ptxas = ptxas_report(f"{built['fusion_attention']}.log", ("cluster_kernel",))
    log_ptxas(k3_ptxas)
    k3_serving = k3_ptxas.get("cluster_kernel<bf16, 256>", {})
    if not k3_serving.get("registers"):
        raise AssertionError("no cluster_kernel<bf16, 256> entry in the -Xptxas -v log")
    if k3_serving.get("spill_stores") or k3_serving.get("spill_loads"):
        raise AssertionError(f"K3's serving template spills: {k3_serving}")
    for dtype in (torch.bfloat16, torch.float32):
        plan = k3[(dtype, 64)]["plan"]
        log(f"K3 {str(dtype)[6:]} plan T=50 dk=2048: route {plan['route']}, clusters of "
            f"{plan['cluster']} blocks x {plan['chunk']} columns, {plan['threads']} threads, "
            f"{plan['key_tile']}-key tiles in a ring of {plan['stages']}, one exchange per "
            f"{plan['group_keys']} keys, {plan['smem_bytes']} B dynamic smem, "
            f"{plan['blocks_per_sm']} blocks per SM, a block owns {plan['rows_per_block']} "
            f"rows of the softmax")
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
    serve_gen, eager_gen = (
        make_generate_step(model32, tok, cfg, 100, with_indication=True, serving=True,
                           device=dev, graphs=graphs) for graphs in (None, False))
    eval_gen = make_generate_step(model32, tok, cfg, 100, with_indication=True,
                                  serving=False, device=dev)
    assert serve_gen.ancestor_kv and serve_gen.fused_topk
    assert not eval_gen.ancestor_kv and not eval_gen.fused_topk
    s_kern = serve_gen(small).cpu().numpy()
    s_eager = eager_gen(small).cpu().numpy()
    s_plain = eval_gen(small).cpu().numpy()
    cap_loop, eag_loop = only_loop(serve_gen), only_loop(eager_gen)
    if not (cap_loop.graphs and only_loop(eval_gen).graphs and not eag_loop.graphs):
        raise AssertionError("phase 3: the default generate step did not capture its loop, "
                             "or graphs=False did")
    same_tok = bool((s_kern == s_eager).all())
    same_score = torch.equal(cap_loop.done_score, eag_loop.done_score)
    agree = float((s_kern == s_plain).mean())
    log(f"reference check (float32, 2 studies): captured vs eager serving path tokens "
        f"equal {same_tok}, scores equal {same_score} (capture {cap_loop.capture_s:.2f}s, "
        f"eval path {only_loop(eval_gen).capture_s:.2f}s); kernels vs reorder + plain tail: "
        f"token agreement {agree:.4f}, {time.perf_counter() - t0:.1f}s")
    if not (same_tok and same_score):
        raise AssertionError("the captured loop disagrees with the eager loop at float32")
    if agree < 0.9:
        raise AssertionError(f"serving path disagrees with the eval path: {agree}")
    del model32, serve_gen, eager_gen, eval_gen, cap_loop, eag_loop
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    early = check_early_stop(dev, args.seed)
    log(f"early-stop check {time.perf_counter() - t0:.1f}s")

    # ---- phase 4: the main path ----
    t0 = time.perf_counter()
    model = flagship(vocab, torch.bfloat16, dev, args.seed)
    batches = []
    for i in range(3):
        bt = example_batch(rng, 64, 64, 224, 100, vocab)
        bt["_image_ids"] = [f"b{i}_s{j}" for j in range(64)]
        batches.append(bt)
    runs, set_up, step_wall, profile = main_path(model, tok, cfg, batches, dev, args.profile)
    log(f"main path phase {time.perf_counter() - t0:.1f}s")
    st = next(r for r in runs if r["mode"] == "captured")
    n_k1, n_k2 = st["launches_lineage"], st["launches_fused"]
    del model, batches
    torch.cuda.empty_cache()

    # ---- phase 5: the fusion module through K3 ----
    t0 = time.perf_counter()
    n_k3, fusion_errs = check_fusion_module(dev, args.seed)
    log(f"fusion module phase: launches fusion_attention={n_k3}, "
        f"{time.perf_counter() - t0:.1f}s")

    # ---- phases 6 and 7: the serve and test CLIs over one synthetic dataset ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        data = write_cli_dataset(root, args.seed)
        cli_res = serve_cli(root, *data)
        t0 = time.perf_counter()
        test_res = test_cli(root, *data, smi, args.seed)
        log(f"test cli phase {time.perf_counter() - t0:.1f}s")

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
            "fusion_attention_ptxas": k3_ptxas,
            "fusion_module": dict(fusion_errs, launches_fusion_attention=n_k3),
            "cli_serve": cli_res, "cli_test": test_res,
            "main_path": dict(st, reference_token_agreement=agree),
            "main_path_runs": runs, "main_path_set_up": set_up,
            "decode_step_wall_ms": step_wall, "early_stop": early,
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
