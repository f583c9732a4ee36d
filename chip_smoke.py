"""Chip smoke test of the PyTorch / CUDA port (evoke_tpu_torch) on one H100.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order (any failure raises and exits non-zero; nothing is skipped):

1. the device: torch's name and nvidia-smi's name and power limit;
2. build every kernel of the serving path from csrc/ (one nvcc per source, in
   parallel), then hold each against its plain PyTorch version on the card at
   the main-path shapes, with the tolerance stated, and time kernel, plain
   version and one library call (CUDA events, median, L2 flushed before each
   launch) beside the bound (bytes over 3.35 TB/s or operations over the
   peak rate, the larger);
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
5. a JSON line of every ported kernel, then the result line.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import json
import math
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


def log(*a):
    print(*a, flush=True)


def time_ms(fn, flush, reps=30):
    """Median CUDA-event time of ``fn`` with the L2 evicted before each launch."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_lineage(dev, flush, g, dtype, lmax, ring):
    from evoke_tpu_torch.ops.lineage_attention import (lineage_attention,
                                                       lineage_attention_plain,
                                                       lineage_masks)

    b, kbeam, d, heads = 64, 3, 512, 8
    n, dh = b * kbeam, d // heads
    q = torch.randn(n, d, generator=g, device=dev).to(dtype)
    ck = torch.randn(n, lmax, d, generator=g, device=dev).to(dtype)
    cv = torch.randn(n, lmax, d, generator=g, device=dev).to(dtype)
    anc = torch.randint(0, kbeam, (b, kbeam, lmax), generator=g, device=dev,
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
    if not err <= tol:
        raise AssertionError(f"lineage_attention L={lmax} ring={ring} {dtype}: max abs "
                             f"err {err} > {tol}")
    # library yardstick: SDPA with the boolean lineage mask over the kbeam*L keys
    mask = lineage_masks(anc, pos, age)                                 # [B,1,k,kL]
    qh = q.reshape(b, kbeam, heads, dh).transpose(1, 2)
    kh = ck.reshape(b, kbeam * lmax, heads, dh).transpose(1, 2)
    vh = cv.reshape(b, kbeam * lmax, heads, dh).transpose(1, 2)
    ms = time_ms(lambda: lineage_attention(q, ck, cv, anc, pos, heads, age=age), flush)
    plain_ms = time_ms(lambda: lineage_attention_plain(q, ck, cv, anc, pos, heads, age=age),
                       flush)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                     flush)
    # bytes this data needs: the K and V rows some query attends, q, out, anc, age
    rows = int(mask[:, 0].any(dim=1).sum())
    isz = q.element_size()
    nbytes = 2 * rows * d * isz + 2 * n * d * isz + anc.numel() * 4 + (b * 4 if ring else 0)
    flops = 4 * kbeam * rows * d          # QK and PV over the attended rows
    bms, by = bound_ms(nbytes, flops, dtype)
    log(f"kernel lineage_attention L={lmax} {'ring' if ring else 'batch'} "
        f"{str(dtype)[6:]}: max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


def check_fused_topk(dev, flush, g, dtype, suppress):
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk, fused_logit_topk_plain

    n, d, v, k = 192, 512, 30001, 3
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
        raise AssertionError(f"fused_logit_topk {dtype} suppress={suppress}: vals err {err} "
                             f"(tol {tol}), lse err {lse_err} (tol 1e-3), {bad_idx} index "
                             "mismatches outside near-ties")
    if any((gi == s).any().item() for s in suppress):
        raise AssertionError("fused_logit_topk returned a suppressed id")
    ms = time_ms(lambda: fused_logit_topk(h, w, b, k, suppress), flush)
    plain_ms = time_ms(lambda: fused_logit_topk_plain(h, w, b, k, suppress), flush)

    def library():
        logits = torch.matmul(h, w.t())
        return torch.logsumexp(logits.float(), -1), torch.topk(logits, k)

    lib_ms = time_ms(library, flush)
    isz = h.element_size()
    nbytes = (v * d + n * d + v) * isz + n * k * 8 + n * 4
    bms, by = bound_ms(nbytes, 2 * n * d * v, dtype)
    log(f"kernel fused_logit_topk {str(dtype)[6:]} suppress={list(suppress)}: "
        f"max_abs_err={err:.3e} (tol {tol}) lse_err={lse_err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} matmul_lse_topk_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=lib_ms)


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
                    "device_ms": e.self_device_time_total / 1e3} for e in kern[:top]]}
    log(f"profile (1 batch): wall_ms={out['wall_ms']:.1f} device_busy_ms="
        f"{out['device_busy_ms']:.1f} busy_share={out['busy_share']:.3f} "
        f"kernel_launches={out['kernel_launches']}")
    for t in out["top"]:
        log(f"  {t['device_ms']:9.3f} ms  x{t['count']:<6d} {t['name']}")
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
                         "and print device busy share and the top kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        sys.exit(2)

    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.ops import _build
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
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
    built = _build.build_all(["lineage_attention", "fused_logit_topk"])
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
    k2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        for suppress in ((), (4,)):
            k2[(dtype, suppress)] = check_fused_topk(dev, flush, g, dtype, suppress)
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

    main1 = k1[(torch.bfloat16, 100, False)]
    main2 = k2[(torch.bfloat16, (4,))]
    kernels = {"kernels": [
        dict(name="lineage_attention", route="cuda",
             source="evoke_tpu_torch/csrc/lineage_attention.cu",
             replaces="evoke_tpu/ops/lineage_attention.py:213", launches=n_k1, **main1),
        dict(name="fused_logit_topk", route="cuda",
             source="evoke_tpu_torch/csrc/fused_logit_topk.cu",
             replaces="evoke_tpu/ops/fused_logit_topk.py:147", launches=n_k2, **main2),
    ]}
    if args.out:
        detail = {
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "lineage_attention": {f"{str(k[0])[6:]}_L{k[1]}_{'ring' if k[2] else 'batch'}": v
                                  for k, v in k1.items()},
            "fused_logit_topk": {f"{str(k[0])[6:]}_sup{len(k[1])}": v for k, v in k2.items()},
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
