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
   sets are identical); the continuous engine (2 slots, captured) decodes
   the same two studies and its best beams must agree with the serving path's
   (token agreement printed, at least 0.9). Then an early-stop check: a full-width one-layer
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
   without the capture time; then the same CLI with ``--decode.engine
   continuous`` (its defaults: 64 slots, 10 x 4 steps a dispatch, 4 loader
   batches a pack) under the same checks;
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
8. the continuous engine at full width: phase 4's flagship (bf16, beam 3,
   suppress_unk) serves 512 studies (8 loader batches of 64, with
   indication) with 64 slots, 10 steps a segment, 4 segments a dispatch, 4
   loader batches a pack, on a forced length mix (a lognormal of median 55
   and sigma 0.45, rounded and clipped to [15, 100], numpy seed 7) through
   the engine's ``topk_wrapper``; captured, then eager, then captured again;
   then the same studies through the batch ReportServer (depth 2, captured,
   warmed on one batch) forced by ``topk_hook``. Every study's forced length
   must be honoured by both engines, the captured and eager runs must agree
   in every report, and K1 must launch 3 times K2 (> 0) in every run. Prints,
   per engine and run: reports/s, decode steps issued, study latency p50 /
   p90, service latency p50, capture seconds and peak GiB, beside the card's
   name and power limit; for the continuous engine reports/s both to its last
   read (the JAX engine's window) and with the drain of the dispatches still
   queued then, and the two engines' ratio with all issued work counted;
9. finetune training: (a) the train step at full width (phase 4's flagship
   widths with the CLI's dense fusion, bf16 over float32 masters), the CLI's
   default batch (32 anchors + 32 aux, uint8 images, 100-token reports with
   indication) and optimizer (RAdam in two groups, clip 0.1): 3 warm-up
   steps, 10 timed (median ms a step, studies/s, peak GiB), 1 under
   torch.profiler (kernel launches a step, device busy share; with
   ``--profile`` its top kernels), 6 more at 100x the learning rates; the
   loss after 20 steps on the repeated batch must be below the first, and
   K1 / K2 / K3 must launch 0 times; (b) one TINY float32 train step (dropout
   off) on the card against the CPU within ``TRAIN_TOL``: loss, every
   gradient, every updated parameter; (c) ``cli finetune`` in-process at full
   width, every CLI default but bf16, over a 224 px synthetic dataset (64
   train / 16 val / 16 test studies, 30000 words) for 1 epoch, then
   ``--trainer.resume auto`` for a second: the current slot, the epoch-2
   start, the run's files, K1 = K2 = K3 = 0 launches;
10. stage-1 pretraining and knowledge retrieval: (a) the pretrain step at
   full width (ResNet-101 @ 224, dense wide-qkv fusion, 768x6 text encoder,
   2048-wide heads; ``pretrain_loss all`` with soft targets), bf16 over
   float32 masters, 32 anchors + 32 aux at 224 px, uint8 images, 100-token
   keyword texts (masks of 40 and 60 tokens), RAdam in one group, clip 0.1,
   dropout on, 20 steps as phase 9 (a) runs them: median ms, studies/s,
   launches, device ms and busy share of one profiled step, peak GiB, the
   loss falling, K1 = K2 = K3 = 0; (b) one TINY float32 pretrain step card
   against CPU within ``TRAIN_TOL``, and the five contrastive losses at
   full shape (64 images, D 2048, T 99, P 49) at float32, card against CPU
   within ``LOSS_TOL``; (c) retrieval: ``encode_images`` over 4 batches of
   the loader's layout (64 anchors + 64 aux, uint8) at full width in bf16
   (ms a batch), then
   ``TopKIndex.search`` with k 20 over a seeded float16 database of 16,384 x
   102,400 rows (3.2 GiB in pinned host memory, streamed in chunks of
   4,096) for 1,024 queries: wall, rows/s, the GEMM's TFLOP/s, the bytes
   copied host -> device and that copy's time alone, the bound (FLOPs over
   the float32 peak or bytes over the 64 GB/s link, the larger); 64 queries
   against a float64 search on the CPU, ids equal wherever the float64
   margin exceeds the printed float32 error bound; (d) ``cli pretrain`` (1
   epoch), ``cli retrieve`` from its ``current`` slot and ``cli finetune``
   over the augmented annotation seeded from that slot (1 epoch), over phase
   9 (c)'s dataset at every default but bf16: walls, the partial-load report,
   K1 = K2 = K3 = 0;
11. the decoder zoo, ViT-B/32, every decoding mode and heatmaps, at full
   width: (a) the flagship's encoder (ResNet-101 @ 224, wide-qkv grouped
   fusion, 768x6 text encoder + BertCrossLayer) with each of
   ``decoder_kind`` causal, bertgen and cmn (d 512 x 3, 8 heads, 30001
   logits, bf16; CMN memory 2048 x 512, top-k 32) serves one batch of 64
   studies (64 anchors + 64 aux, with indication) at beam 3 through
   ReportServer, captured, after a warm-up batch: K1 must launch 3 times a
   decode step and K2 never; at float32 on 2 studies the serving path
   captured and eager must agree bit for bit (tokens, scores) and the eval
   path's best beams agree with the serving path's (token agreement printed,
   at least 0.9); (b) ViT-B/32 @ 224 with the flagship's R2Gen decoder over
   the same batch: K1 = 3 and K2 = 1 a step; its encode ms a batch beside
   ResNet-101's; (c) on the flagship, one batch of 64 in each decoding mode:
   greedy with trigram blocking, sample at T 0.7, top-k 8, top-p 0.9,
   sample_n 3, diverse beam (beam 6, group 2: K1 = 600 a batch), diverse
   sampling (group 3), int8 caches at beam 3 (K1 = 0, K2 = 1 a step; the
   others K1 = K2 = 0); greedy and diverse beam captured == eager at float32
   on 2 studies; each sampled mode gives the same reports twice under one
   seed and others under seed 1, and (but diverse sampling) every token it
   samples at float32 on 2 studies, captured, lies in its step's kept set;
   int8's reports are compared with a bf16-cache run on the same (reorder)
   route and its cache bytes printed beside bf16's; (d) ``cli test
   --trainer.plot_heatmaps 2`` in-process over phase 7's dataset and
   configuration (run right after phase 7): one PNG per decoder layer and
   word of the studies drawn, and the attention maps of a float32 copy of
   the CLI's weights card vs CPU within ``HEATMAP_TOL``. Each part prints
   reports/s, p50, peak GiB, capture seconds and its launch counts
   (``--profile``: a profile of one batch of each zoo decoder, greedy,
   diverse beam and int8);
12. an EVOKE checkpoint imported and served: (a) a FineTune state dict in
   EVOKE's released layout (``models/evoke_layout.py``: ResNet-101 under
   ``visual_extractor.model.{0,1,4..7}``, the 768x6 text encoder, wide-qkv
   fusion, both projection heads, the co-attention stacks, the R2Gen
   decoder d 512 x 3 with 30001 logits, every BatchNorm's
   ``num_batches_tracked``) is drawn from the seed and written with
   ``torch.save`` (its GiB printed); (b) ``load_finetune_checkpoint`` fills
   a freshly initialised bf16 flagship on the card: seconds in ``torch.load``
   and in the import, the report, which must be every mapped tensor loaded
   and 0 mismatched, 0 missing (JAX's counts for this layout,
   tests/test_torch_port_torch_import.py), and every imported tensor
   bit-equal on the card to its source cast to bf16; (c) one 64-study batch
   (64 anchors + 64 aux, with indication) served at bf16, beam 3, through
   ReportServer, captured, after a warm-up batch, 3 times at depth 2 (as
   phase 11): reports/s, p50, peak GiB, capture seconds, K1 = 300, K2 =
   100, K3 = 0 a batch; a float32 flagship
   importing the same tensors decodes 2 studies on the card and on the CPU
   and the best beams must be identical; (d) the port's native library is
   built with g++ (run with phase 7's dataset: ``NativeWordLevel`` against the
   Python ``WordTokenizer`` on every report) and ``core.profiling``'s
   ``capture_trace`` around the served batch gives a digest whose loop ops
   hold ``lineage_kernel``;
13. data parallelism (``core/mesh``, ``parallel/collectives``): (a) right
   after phase 6, in a real NCCL process group of size 1 made in this
   process, ``cli serve --decode.serve_dp -1`` on both engines over phase
   6's dataset and configuration: ``serving mesh: dp=1``, the CSV equal to
   phase 6's row for row, K1 and K2 launched as often as in phase 6,
   reports/s and p50 beside phase 6's; (d) in the same group,
   ``evoke_tpu_torch.dryrun``'s 5 stages at world size 1 (train step,
   beam-3 decode, checkpoint save / restore / step, the wide fusion, the
   continuous engine with K1 and K2 launched); then, after phase 12, two
   ranks spawned on the one card over gloo on CUDA tensors (NCCL refuses two
   ranks on one device): (b) the float32 flagship decodes 2 studies a rank
   through ``make_generate_step(mesh=)`` and the gathered best beams must be
   the one-device serving path's; the bf16 flagship serves one 64-study
   batch, 32 a rank, captured: each rank's K1 (3 a step), K2 (1 a step at N
   96), reports/s (information: the ranks share the card) and peak GiB;
   (c) the TINY float32 finetune and pretrain steps (phase 9 (b) / 10 (b)'s
   models, dropout on) against the one-rank step on the global batch (loss
   within 1e-5 relative, parameters within ``DP_PARAM_TOL``, each update
   within 1e-3 of the first RAdam step's size of the one-rank update (2e-2
   in L2 norm in the ResNet), most parameters moved, bit-identical across
   the ranks by checksum), then the full-width bf16 finetune step at
   16 + 16 a rank: step ms, peak GiB a rank, K1 = K2 = K3 = 0;
14. tensor parallelism (``parallel/tp``), after phase 13, on ranks spawned
   on the one card over gloo: two ranks at dp=1 x mp=2 run (a) the wide
   fusion module at phase 5's layout (bf16) sharded over mp: K3 on the
   rank's 4 of 8 heads (its launches counted), the module against the
   one-device module within ``FUSION_TOL``, K3 on the rank's heads against
   its plain version within ``K3_TOL``; (b) the float32 flagship's best
   beams of 4 studies at mp=2 (eager, K1 and K2 declined) must equal one
   device's on the same routes (agreement with its K1 + K2 path printed);
   the bf16 flagship serves one 64-study batch eagerly: reports/s, peak
   GiB, the rank's parameter bytes beside one device's, K1 = K2 = K3 = 0;
   (c) the full-width bf16 finetune step at 16 + 16: step ms and peak GiB a
   rank; then four ranks at dp=2 x mp=2 run the TINY finetune and pretrain
   steps against the one-rank step with phase 13 (c)'s bounds, replicated
   and gathered parameters bit-identical on every rank; (d)
   ``evoke_tpu_torch.dryrun``'s 5 stages at 4 ranks (dp=2 x mp=2 for
   stages 1-4) on the card;
15. a JSON line of every ported kernel (launches: phase 4's captured run;
   ``launches_phase11``: each phase 11 path's count; ``launches_phase12``:
   phase 12's served batch; ``launches_phase13`` / ``launches_phase14``:
   each phase 13 / 14 path's), then the result line.

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
    from evoke_tpu_torch.data.datasets import load_annotation, parse_finetune
    from evoke_tpu_torch.data.synthetic import write_synthetic_dataset

    t0 = time.perf_counter()
    ann = write_synthetic_dataset(root, n_train=8, n_val=0, n_test=160, image_size=224,
                                  seed=seed)
    has_ind, no_ind = parse_finetune(load_annotation(ann), "test")
    if len(has_ind) < 96 or not no_ind:
        raise AssertionError(f"synthetic split: {len(has_ind)} studies with "
                             f"indication, {len(no_ind)} without")
    tok_dir = write_cli_tokenizer(root, ann)
    log(f"cli data: {len(has_ind)} test studies with indication, {len(no_ind)} "
        f"without, 224 px .npy, {time.perf_counter() - t0:.1f}s")
    return ann, tok_dir, has_ind, no_ind


def write_cli_tokenizer(root, ann, size=30000):
    """A ``size``-word vocab where build_tokenizer looks (``root``/tok): the
    dataset's words first. Returns the tokenizer dir."""
    import os

    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.data.tokenizer import WordTokenizer

    words = {w: i for w, i in WordTokenizer.train(
        r["report"] for r in load_annotation(ann)["train"]).vocab.items()
        if w not in ("[BOS]", "[EOS]")}                  # re-appended last
    for i in range(size - 2 - len(words)):
        words[f"w{i}"] = len(words)
    tok = WordTokenizer(words)
    assert tok.get_vocab_size() == size
    tok_dir = os.path.join(root, "tok")
    os.makedirs(tok_dir)
    tok.save(os.path.join(tok_dir, "mimic_cxr_wordlevel_uncased_tokenizer.json"))
    return tok_dir


def serve_cli(root, ann, tok_dir, has_ind, no_ind, engine="batch", serve_dp=0):
    """The serve CLI in-process at full width over the synthetic dataset:
    every CLI default but bf16 (and ``--decode.engine``; ``serve_dp``:
    ``--decode.serve_dp``, into a version of its own). Returns the phase's
    numbers."""
    import contextlib
    import csv
    import io
    import os

    from evoke_tpu_torch import cli, serve
    from evoke_tpu_torch.decode import continuous
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    stats = []
    cls = continuous.ContinuousServer if engine == "continuous" else serve.ReportServer
    serve_fn = cls.serve

    def recording_serve(self, *a, **kw):
        out = serve_fn(self, *a, **kw)
        stats.append(dict(self.stats))
        return out

    cls.serve = recording_serve
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    masked_cross_view_attention.launches = 0
    version = f"{engine}_dp" if serve_dp else engine
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["serve", "--data.ann_path", ann, "--data.image_dir", root,
                           "--data.tokenizer_dir", tok_dir,
                           "--trainer.result_dir", os.path.join(root, "results"),
                           "--model.dtype", "bfloat16", "--decode.engine", engine,
                           "--trainer.version", version,
                           "--decode.serve_dp", str(serve_dp)])
        torch.cuda.synchronize()
    finally:
        cls.serve = serve_fn
    wall = time.perf_counter() - t0
    n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
    n_k3 = masked_cross_view_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    printed = buf.getvalue().strip().splitlines()
    log("cli stdout: " + " | ".join(printed))
    if rc != 0:
        raise AssertionError(f"cli serve returned {rc}")
    summary = json.loads(printed[-1])
    csv_path = os.path.join(root, "results", "mimic_cxr", "serve", version,
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
    capture_s = sum(s["capture_s"] for s in stats)
    if capture_s <= 0:
        raise AssertionError(f"cli serve ({engine}): the decode steps were not captured")
    served_s = sum(s["wall_s"] for s in stats) - capture_s
    out = dict(engine=engine, reports=summary["reports"], reports_per_s=summary["reports_per_s"],
               capture_s=capture_s, reports_per_s_without_capture=summary["reports"] / served_s,
               serve_wall_s=summary["wall_s"], peak_mem_gib=peak_gib,
               cli_wall_s=wall, launches_lineage=n_k1, launches_fused=n_k2,
               launches_fusion_attention=n_k3, csv_rows=rows, printed=printed)
    if engine == "continuous":
        # the batch engine's wall covers all the work it issued; count the
        # speculative dispatches the card runs after the last read too
        drained_s = served_s + sum(s["drain_s"] for s in stats)
        out.update(study_p50_ms=[s["study_p50_ms"] for s in stats],
                   segment_steps=[s["segment_steps"] for s in stats],
                   issued_steps=[s["issued_steps"] for s in stats],
                   drain_s=[s["drain_s"] for s in stats],
                   drained_reports_per_s_without_capture=summary["reports"] / drained_s)
        latency = f"study_p50_ms={[round(x, 1) for x in out['study_p50_ms']]}, decode steps " \
                  f"consumed {out['segment_steps']} issued {out['issued_steps']}; " \
                  f"{out['drained_reports_per_s_without_capture']:.3f} reports/s without the " \
                  f"capture with the drain of {[round(x, 3) for x in out['drain_s']]} s"
        what = f"{len(stats)} serve() calls of one server"
    else:
        out.update(batch_latency_p50_s=[s["batch_latency_p50_s"] for s in stats],
                   batches=[s["batches"] for s in stats])
        latency = f"batch_latency_p50_s={[round(x, 4) for x in out['batch_latency_p50_s']]}"
        what = f"{len(stats)} loops"
    log(f"cli serve --decode.engine {engine}{f' --decode.serve_dp {serve_dp}' if serve_dp else ''}"
        f": {summary['reports']} reports, reports_per_s="
        f"{summary['reports_per_s']} with the capture of the decode steps "
        f"({capture_s:.2f}s, {what}), "
        f"{out['reports_per_s_without_capture']:.3f} without (serve wall "
        f"{summary['wall_s']} s; with/without indication {latency}), cli wall "
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


def profile_serving(run, what="1 batch", top=15, ported=PORTED_KERNELS, quiet=False):
    """``run()`` (a server serving) under torch.profiler: device busy share of
    the window (sum of kernel times over wall time; the profiler's own host
    cost lengthens the wall) and the kernels with the most device time; each
    of ``ported`` (fragments of kernel names) must be among them. ``quiet``
    prints the summary line only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
    for frag in ported:   # each hand-written kernel, wherever it ranks
        hits = [e for e in kern if frag in e.key]
        out["ported"][frag] = {"count": sum(e.count for e in hits),
                               "device_ms": sum(e.self_device_time_total for e in hits) / 1e3}
        if out["ported"][frag]["count"] <= 0:
            raise AssertionError(f"profile: no launch of a kernel named *{frag}* in "
                                 f"{what}")
    log(f"profile ({what}): wall_ms={out['wall_ms']:.1f} device_busy_ms="
        f"{out['device_busy_ms']:.1f} busy_share={out['busy_share']:.3f} "
        f"kernel_launches={out['kernel_launches']}")
    if quiet:
        return out
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
            profile = profile_serving(lambda: server.serve(batches[:1], with_indication=True))
    return runs, set_up, step_wall, profile


def spelled_tokens(records, max_len, pad_id):
    """[studies, max_len] ids of spelled-id reports, PAD after EOS."""
    out = np.full((len(records), max_len), pad_id, np.int64)
    for i, r in enumerate(records):
        ids = [int(x) for x in r["report"].split()]
        out[i, :len(ids)] = ids
    return out


# the forced length mix of the engines' A/B: MIMIC-like report lengths
FORCED_MEDIAN, FORCED_SIGMA, FORCED_CLIP, FORCED_SEED = 55.0, 0.45, (15, 100), 7


def forced_lengths(n):
    lo, hi = FORCED_CLIP
    return np.clip(np.round(np.random.default_rng(FORCED_SEED).lognormal(
        np.log(FORCED_MEDIAN), FORCED_SIGMA, n)), lo, hi).astype(np.int32)


def continuous_engine(model, cfg, vocab, dev, seed, smi, with_profile=False):
    """Phase 8: the continuous engine against the batch engine on the forced
    length mix at full width. ``with_profile``: the warm captured engine serves
    the first 2 loader batches once more under torch.profiler. Returns the
    phase's numbers."""
    import gc

    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.decode.forcing import force_topk, synthetic_tokenizer
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.serve import ReportServer

    tok = synthetic_tokenizer(vocab, spell_ids=True)
    eos, beam, slots, n_batches, width = tok.eos_id, cfg.beam_size, 64, 8, 64
    lengths = forced_lengths(n_batches * width).reshape(n_batches, width)
    rng = np.random.default_rng(seed + 8)
    batches = []
    for i in range(n_batches):
        bt = example_batch(rng, width, width, 224, 100, vocab)
        bt["_image_ids"] = [f"c{i}_s{j}" for j in range(width)]
        bt["_aux"] = bt["target_len"] = lengths[i]     # engine: host aux; batch: hook's batch
        batches.append(bt)
    want = {iid: int(n) for bt in batches for iid, n in zip(bt["_image_ids"], bt["_aux"])}

    def honoured(records):
        return {r["id"]: len(r["report"].split()) for r in records} == want

    def wrapper(vals, idx, lse, age_rows, aux):
        return force_topk(vals, idx, age_rows, aux.repeat_interleave(beam), eos)

    def hook(vals, idx, lse, tok_ids, pos, batch):
        return force_topk(vals, idx, torch.full(vals.shape[:1], pos, device=vals.device),
                          batch["target_len"].repeat_interleave(beam), eos)

    def counted(run):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lineage_attention.launches = fused_logit_topk.launches = 0
        out = run()
        torch.cuda.synchronize()
        n_k1, n_k2 = lineage_attention.launches, fused_logit_topk.launches
        if n_k2 <= 0 or n_k1 != 3 * n_k2:
            raise AssertionError(f"phase 8 launch counts: lineage {n_k1}, fused {n_k2} "
                                 "(want 3:1, > 0)")
        return out, dict(launches_lineage=n_k1, launches_fused=n_k2,
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    runs, servers, reports, profile = [], {}, {}, None
    for mode in ("captured", "eager", "captured"):
        if mode not in servers:
            servers[mode] = ContinuousServer(
                model, tok, max_seq_len=100, slots=slots, beam_size=beam, seg_steps=10,
                dispatch_segs=4, pack_batches=4, suppress_unk=True, topk_wrapper=wrapper,
                device=dev, graphs=None if mode == "captured" else False)
        srv = servers[mode]
        (recs, st), counts = counted(lambda: srv.serve(batches))
        if not honoured(recs):
            raise AssertionError(f"continuous {mode}: a forced length was not honoured")
        if srv.loop.graphs != (mode == "captured"):
            raise AssertionError(f"continuous {mode}: loop graphs={srv.loop.graphs}")
        run = dict(st, engine="continuous", mode=mode, steps_issued=srv.loop.steps_run,
                   **counts)
        if reports and reports != {r["id"]: r["report"] for r in recs}:
            raise AssertionError(f"continuous {mode}: reports differ from the first run's")
        reports = {r["id"]: r["report"] for r in recs}
        runs.append(run)
        log(f"engines [{smi}] continuous {mode}: {len(recs)} reports, reports_per_s="
            f"{st['reports_per_s']:.2f} to the last read, {st['drained_reports_per_s']:.2f} "
            f"with the drain ({st['drain_s']:.3f}s after it), decode steps issued "
            f"{run['steps_issued']} (consumed {st['segment_steps']:.0f}), study latency p50 "
            f"{st['study_p50_ms']:.1f} / p90 {st['study_p90_ms']:.1f} ms, service p50 "
            f"{st['service_p50_ms']:.1f} ms, capture {st['capture_s']:.2f}s, wall {st['wall_s']:.3f}s (encode {st['encode_s']:.3f}, "
            f"dispatch {st['dispatch_s']:.3f}, wait {st['wait_s']:.3f}), peak_mem_gib="
            f"{counts['peak_mem_gib']:.2f}, launches lineage={counts['launches_lineage']} "
            f"fused={counts['launches_fused']}")
        if with_profile and len(runs) == 3:
            profile = profile_serving(lambda: srv.serve(batches[:2]),
                                      "continuous engine, 128 studies")
    del servers
    bsrv = ReportServer(model, tok, cfg, max_seq_len=100, depth=2, device=dev, topk_hook=hook)
    t0 = time.perf_counter()
    bsrv.serve(batches[:1], with_indication=True)
    torch.cuda.synchronize()
    warm_s, capture_s = time.perf_counter() - t0, bsrv.stats["capture_s"]
    recs, counts = counted(lambda: bsrv.serve(batches, with_indication=True))
    if not honoured(recs):
        raise AssertionError("batch engine: a forced length was not honoured")
    st = bsrv.stats
    run = dict(st, engine="batch", mode="captured", steps_issued=counts["launches_fused"],
               warm_up_s=warm_s, warm_up_capture_s=capture_s, **counts)
    runs.append(run)
    mean_len = float(lengths.mean())
    warm = runs[2]
    log(f"engines [{smi}] continuous captured warm / batch captured, all issued work counted: "
        f"{warm['drained_reports_per_s']:.2f} / {st['reports_per_s']:.2f} reports/s = "
        f"{warm['drained_reports_per_s'] / st['reports_per_s']:.3f}x ({warm['steps_issued']} / "
        f"{run['steps_issued']} steps issued); to the continuous engine's last read "
        f"{warm['reports_per_s'] / st['reports_per_s']:.3f}x")
    log(f"engines [{smi}] batch captured (warmed on one batch, capture {capture_s:.2f}s): "
        f"{len(recs)} reports, reports_per_s={st['reports_per_s']:.2f}, decode steps issued "
        f"{run['steps_issued']} ({run['steps_issued'] / n_batches:.1f} a batch of {width}), "
        f"study latency = batch latency p50 {st['batch_latency_p50_s'] * 1e3:.1f} / p90 "
        f"{st['batch_latency_p90_s'] * 1e3:.1f} ms, service p50 = study (no admission queue), "
        f"capture 0.00s in this run, peak_mem_gib={counts['peak_mem_gib']:.2f}, launches "
        f"lineage={counts['launches_lineage']} fused={counts['launches_fused']}")
    log(f"engines: forced mix {n_batches * width} studies, mean length {mean_len:.2f}, max "
        f"{int(lengths.max())}, {int((lengths == FORCED_CLIP[1]).sum())} at the cap; sum of "
        f"lengths / slots = {lengths.sum() / slots:.1f} steps; batch max lengths "
        f"{[int(x) for x in lengths.max(1)]}")
    del bsrv
    torch.cuda.empty_cache()
    return dict(runs=runs, mean_length=mean_len, lengths_sum=int(lengths.sum()),
                batch_max_lengths=[int(x) for x in lengths.max(1)], profile=profile)


# ---- phase 9: finetune training ----

# the port's TINY test dims (tests/_torch_port_util.TINY)
TRAIN_TINY = dict(output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
                  encoder_num_heads=2, encoder_intermediate_size=64, d_model=32, d_ff=64,
                  num_heads=2, num_layers=2, rm_num_slots=3, rm_d_model=32,
                  fusion_num_heads=2, fusion_intermediate_size=64, sk_fusion_num_layers=1,
                  max_seq_len=16, fusion_wide_qkv=False)
# one TINY float32 train step, card against CPU (TF32 off): the loss 1e-4
# relative; gradients outside the ResNet 1e-3 of (the leaf's largest + 1e-3 of
# the largest gradient); the ResNet's 3e-2 in L2 norm relative (33
# batch-statistics BatchNorm blocks over 4 images amplify float32 rounding
# ~1.3x a block: the port's float32 step on one CPU is only that close to its
# float64 step); updated parameters within the learning rate times their
# gradient's difference, plus 1e-6 relative
TRAIN_TOL = dict(loss=1e-4, grad=1e-3, resnet_l2=3e-2)
TRAIN_LR = dict(pt_lr=1e-2, ft_lr=3e-2, weight_decay=1e-4, grad_clip_value=0.1)


def train_case(model, opt_name, lr, batch, with_indication, dropout=True, seed=0,
               task="finetune"):
    """One train step of ``model`` (a copy is not made): (the step's metrics,
    the gradients the optimizer was given, the updated parameters)."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    opt = build_optimizer(opt_name, task, model, **lr)
    seen = {}
    step = opt.step

    def recording(grads):
        seen.update({k: g.detach().float().cpu() for k, g in grads.items() if g is not None})
        return step(grads)

    opt.step = recording
    out = make_train_step(model, opt, seed, with_indication=with_indication, task=task,
                          dropout=dropout)(TrainState(model, opt), batch)
    params = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    return {k: float(v) for k, v in out.items()}, seen, params


def tiny_train_model(dtype=torch.float32, seed=0, task="finetune", **kw):
    """The TINY model of ``task`` (the flagship, or the pretrain model at its
    share of the dims) on the CPU, seeded, each Bottleneck's bn3 scale x 0.1
    (keeps the batch-statistics forward well conditioned at 4 images)."""
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.models.pretrain import PretrainModel
    from evoke_tpu_torch.params import init_params_

    if task == "pretrain":
        dims = {k: TRAIN_TINY[k] for k in ("output_dim", "encoder_hidden_size",
                                            "encoder_num_layers", "encoder_num_heads",
                                            "encoder_intermediate_size", "fusion_wide_qkv")}
        model = PretrainModel(vocab_size=50, dtype=dtype, **dims, **kw)
    else:
        model = FinetuneModel(vocab_size=50, dtype=dtype, **TRAIN_TINY, **kw)
    model = init_params_(model, seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.mul_(0.1)
    return model


def train_card_vs_cpu(dev, seed, task="finetune"):
    """Phase 9 (b) / 10 (b): one TINY float32 train step of ``task`` (RAdam:
    two groups for finetune, one for pretrain; dropout off, BatchNorm on batch
    statistics) on the card and on the CPU."""
    import copy

    rng = np.random.default_rng(seed + 11)
    bt = example_batch(rng, 2, 2, 64, 16, 50)
    bt["mask"][1, 12:] = 0
    bt["valid"][3] = False
    bt["images"][3] = 0.0
    model = tiny_train_model(seed=seed, task=task)
    finetune = task == "finetune"
    cpu = train_case(copy.deepcopy(model), "RAdam", TRAIN_LR,
                     {k: torch.as_tensor(v) for k, v in bt.items()}, finetune, dropout=False,
                     task=task)
    card = train_case(copy.deepcopy(model).to(dev), "RAdam", TRAIN_LR,
                      {k: torch.as_tensor(v).to(dev) for k, v in bt.items()}, finetune,
                      dropout=False, task=task)
    key = "lm" if finetune else "all_loss"
    loss_err = max(abs(card[0][k] - v) / max(abs(v), 1e-6) for k, v in cpu[0].items())
    gmax = max(g.abs().max().item() for g in cpu[1].values())
    worst, resnet = 0.0, [0.0, 0.0]
    for name, want in cpu[1].items():
        got = card[1][name]
        if name.startswith("visual_extractor."):
            resnet[0] += float(((got - want) ** 2).sum())
            resnet[1] += float((want ** 2).sum())
            continue
        err = (got - want).abs().max().item() / (want.abs().max().item() + 1e-3 * gmax)
        worst = max(worst, err)
    resnet_l2 = math.sqrt(resnet[0] / resnet[1])
    bad_params = []
    for name, want in cpu[2].items():
        lr = TRAIN_LR["ft_lr"] if finetune and any(s in name for s in (
            "text_decoder", "visual_self_atten", "multimodal_fusion", "visual_head",
            "text_head")) else TRAIN_LR["pt_lr"]
        g_err = (card[1].get(name, torch.zeros_like(want))
                 - cpu[1].get(name, torch.zeros_like(want))).abs()
        if ((card[2][name] - want).abs() > lr * g_err * 1.01 + 1e-6 * want.abs()
                + 1e-7).any():
            bad_params.append(name)
    out = dict(loss_cpu=cpu[0][key], loss_card=card[0][key], loss_rel_err=loss_err,
               grad_err=worst, resnet_grad_l2_err=resnet_l2, params_outside=bad_params)
    log(f"{task} train step card vs CPU (TINY, float32, TF32 off, RAdam, dropout off): "
        f"{key} {card[0][key]:.6f} vs {cpu[0][key]:.6f} (largest rel err of the step's "
        f"losses {loss_err:.2e}, tol {TRAIN_TOL['loss']}); gradients outside the ResNet "
        f"{worst:.2e} (tol {TRAIN_TOL['grad']}), ResNet L2 {resnet_l2:.2e} (tol "
        f"{TRAIN_TOL['resnet_l2']}); updated parameters outside lr x gradient difference: "
        f"{len(bad_params)}")
    if (loss_err > TRAIN_TOL["loss"] or worst > TRAIN_TOL["grad"]
            or resnet_l2 > TRAIN_TOL["resnet_l2"] or bad_params):
        raise AssertionError(f"{task} train step card vs CPU: {out}")
    return out


def train_step_full_width(vocab, dev, seed, smi, with_profile, task="finetune"):
    """Phase 9 (a) / 10 (a): the train step of ``task`` at full width
    (ResNet-101 @ 224, dense wide-qkv fusion, 768x6 encoder; finetune adds a
    BertCrossLayer and the R2Gen decoder 512 x 3 with 30001 logits; pretrain
    adds two 2048-wide projection heads and the contrastive losses, ``all``
    with soft targets), bf16 over float32 masters, the CLI's default batch
    (32 anchors + 32 aux, uint8 images, 100-token texts with masks of 40 and
    60 tokens; finetune with indication) and optimizer (RAdam, two groups for
    finetune, one for pretrain, clip 0.1), dropout on; 20 steps on one
    repeated batch: 3 warm-up, 10 timed, 1 profiled (the launches a step), 6
    more with the learning rates x 100 so that 20 steps can show the loss
    falling."""
    from evoke_tpu_torch.core.config import OptimConfig
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.models.pretrain import PretrainModel
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.optim import build_optimizer, set_lr_scale
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    o = OptimConfig()
    t0 = time.perf_counter()
    n_anchor, image_size, seq = 32, 224, 100
    finetune = task == "finetune"
    key = "lm" if finetune else "all_loss"
    with torch.device(dev):
        model = (FinetuneModel(vocab_size=vocab, max_seq_len=seq, dtype=torch.bfloat16)
                 if finetune else PretrainModel(vocab_size=vocab, dtype=torch.bfloat16))
    init_params_(model, seed)
    opt = build_optimizer(o.optim, task, model, pt_lr=o.pt_lr, ft_lr=o.ft_lr,
                          weight_decay=o.weight_decay, grad_clip_value=o.grad_clip_value)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, seed, with_indication=finetune, task=task)
    rng = np.random.default_rng(seed + 5)
    bt = example_batch(rng, n_anchor, n_anchor, image_size, seq, vocab)
    bt["images"] = rng.integers(0, 256, size=bt["images"].shape, dtype=np.uint8)
    bt["mask"][:, seq * 3 // 5:] = 0
    bt["mask"][::2, seq * 2 // 5:] = 0
    if not finetune:
        del bt["inc_ids"], bt["inc_mask"]
        bt["ids"] *= bt["mask"]                           # pads after the keywords
    batch = {k: torch.as_tensor(v).to(dev) for k, v in bt.items()}
    n_params = sum(p.numel() for p in model.parameters())
    set_up = time.perf_counter() - t0
    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    masked_cross_view_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(13):
        t1 = time.perf_counter()
        losses.append(step(state, batch)[key])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_serving(lambda: losses.append(step(state, batch)[key]),
                           what="1 train step", ported=(), quiet=not with_profile)
    set_lr_scale(opt, 100.0)
    for i in range(6):
        losses.append(step(state, batch)[key])
    losses = torch.stack(losses).float().cpu().tolist()
    kernels = (lineage_attention.launches, fused_logit_topk.launches,
               masked_cross_view_attention.launches)
    ms = statistics.median(times[3:]) * 1e3
    out = dict(params=n_params, set_up_s=set_up, step_ms=ms, step_ms_all=[t * 1e3 for t in times],
               studies_per_s=n_anchor / (ms / 1e3), peak_mem_gib=peak_gib,
               launches_per_step=prof["kernel_launches"], busy_share=prof["busy_share"],
               profiled_wall_ms=prof["wall_ms"], device_busy_ms=prof["device_busy_ms"],
               losses=losses, launches_k1_k2_k3=kernels, top=prof["top"] if with_profile else [])
    texts = ("100-token reports, with indication" if finetune
             else "100-token keyword texts, pretrain_loss all, soft targets")
    log(f"{'train' if finetune else 'pretrain'} step [{smi}]: bf16 over float32 masters, "
        f"{n_params / 1e6:.1f}M parameters, batch {n_anchor} + {n_anchor} aux at "
        f"{image_size} px, {texts}, RAdam: "
        f"step_ms={ms:.1f} (median of 10 after 3 warm-up), studies_per_s="
        f"{out['studies_per_s']:.1f}, peak_mem_gib={peak_gib:.2f}, launches_per_step="
        f"{out['launches_per_step']}, device_ms={out['device_busy_ms']:.1f}, busy_share="
        f"{out['busy_share']:.3f} (1 profiled step); {key} step 1 {losses[0]:.4f} -> step 20 "
        f"{losses[-1]:.4f}; K1/K2/K3 launches {kernels}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{task} step: the loss did not fall over 20 steps: {losses}")
    if any(kernels):
        raise AssertionError(f"{task} step launched a decode kernel: {kernels}")
    del model, opt, state, batch
    torch.cuda.empty_cache()
    return out


def finetune_cli(root, seed, smi):
    """Phase 9 (c): ``cli finetune`` in-process at full width, every CLI
    default but bf16 and 1 epoch, over a synthetic 224 px dataset (64 train /
    16 val / 16 test studies, a 30000-word tokenizer), then ``--trainer.resume
    auto`` for a second epoch. K1, K2 and K3 must launch 0 times (training
    and the eval path reach none of them)."""
    import contextlib
    import io
    import os

    from evoke_tpu_torch import cli
    from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention
    from evoke_tpu_torch.train import trainer

    t0 = time.perf_counter()
    splits = (64, 16, 16)
    ann = write_synthetic_dataset(root, n_train=splits[0], n_val=splits[1],
                                  n_test=splits[2], image_size=224, seed=seed)
    tok_dir = write_cli_tokenizer(root, ann)
    data_s = time.perf_counter() - t0
    res = os.path.join(root, "results")
    argv = ["--data.ann_path", ann, "--data.image_dir", root, "--data.tokenizer_dir", tok_dir,
            "--trainer.result_dir", res, "--model.dtype", "bfloat16",
            "--trainer.resume", "auto"]
    epochs, save_s = [], []
    epoch_fn, save_fn = trainer.FinetuneTrainer._train_epoch, trainer.BaseTrainer._save

    def timed_epoch(self, epoch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        log_ = epoch_fn(self, epoch)
        epochs.append((epoch, time.perf_counter() - t, dict(self.stats)))
        return log_

    def timed_save(self, *a):
        t = time.perf_counter()
        save_fn(self, *a)
        self.ckpt.wait()
        save_s.append(time.perf_counter() - t)

    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    masked_cross_view_attention.launches = 0
    trainer.FinetuneTrainer._train_epoch, trainer.BaseTrainer._save = timed_epoch, timed_save
    walls = []
    buf = io.StringIO()
    try:
        for n in (1, 2):
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["finetune"] + argv + ["--trainer.epochs", str(n)])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
            if rc != 0:
                raise AssertionError(f"cli finetune returned {rc}")
            gc_cuda()
    finally:
        trainer.FinetuneTrainer._train_epoch, trainer.BaseTrainer._save = epoch_fn, save_fn
    kernels = (lineage_attention.launches, fused_logit_topk.launches,
               masked_cross_view_attention.launches)
    run = os.path.join(res, "mimic_cxr", "finetune", "v1")
    files = sorted(os.listdir(run))
    want = ["checkpoint", "config.json", "finetune.log", "metrics.jsonl",
            "mimic_cxr_finetune_results_record.csv", "test_prediction.csv",
            "val_prediction.csv"]
    with open(os.path.join(run, "finetune.log")) as f:
        text = f.read()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    slot = os.path.join(run, "checkpoint", "current", "state.pt")
    problems = []
    if files != want:
        problems.append(f"files {files}")
    if not os.path.isfile(slot):
        problems.append("no current slot")
    if "resumed from current: epoch 2" not in text:
        problems.append("the second run did not start at epoch 2")
    if [r["epoch"] for r in recs] != [1, 2] or not all(
            math.isfinite(r["train_lm"]) for r in recs):
        problems.append(f"metrics.jsonl epochs {[r.get('epoch') for r in recs]}")
    if [e for e, _, _ in epochs] != [1, 2]:
        problems.append(f"epochs run {[e for e, _, _ in epochs]}")
    if any(kernels):
        problems.append(f"K1/K2/K3 launches {kernels}")
    out = dict(data_s=data_s, cli_wall_s=walls, epoch_s=[s for _, s, _ in epochs],
               eval_stats=[st for _, _, st in epochs], save_s=save_s,
               checkpoint_gib=os.path.getsize(slot) / 2 ** 30 if os.path.isfile(slot) else None,
               train_lm=[r["train_lm"] for r in recs], launches_k1_k2_k3=kernels,
               files=files)
    log(f"cli finetune [{smi}]: {splits[0]} train / {splits[1]} val / {splits[2]} test "
        f"studies, bf16, 1 epoch then "
        f"--trainer.resume auto for epoch 2: cli wall {[round(w, 1) for w in walls]} s, "
        f"epochs (train + val/test decode and metrics) "
        f"{[round(s, 1) for s in out['epoch_s']]} s, checkpoint saves "
        f"{[round(s, 1) for s in save_s]} s of {out['checkpoint_gib'] or 0:.2f} GiB, "
        f"train_lm {[round(x, 4) for x in out['train_lm']]}, K1/K2/K3 launches {kernels}; "
        f"data {data_s:.1f}s")
    if problems:
        raise AssertionError(f"cli finetune: {problems}")
    return out


# ---- phase 10: stage-1 pretraining and knowledge retrieval ----

LOSS_TOL = 1e-5             # each contrastive loss, card against CPU at float32 (relative)
# the host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s each way (NVIDIA's data
# sheet gives 128 GB/s, both directions together)
LINK_BYTES_PER_S = 64e9
FLOAT32_UNIT = 2.0 ** -24   # float32 unit roundoff


def contrastive_losses_card_vs_cpu(dev, seed):
    """Phase 10 (b): each of the five contrastive losses at full shape (64
    images, D 2048; tokens T 99 against P 49 patches), float32, card against
    CPU within ``LOSS_TOL`` relative; studies of 1-3 views, 4 rows padded."""
    from evoke_tpu_torch.losses import contrastive as cl

    rng = np.random.default_rng(seed + 21)
    b, d, t, p = 64, 2048, 99, 49
    pids = np.repeat(np.arange(32), 2)[:b]
    pids[::5] = 1000 + np.arange(len(pids[::5]))          # some views without a partner
    valid = np.ones(b, bool)
    valid[-4:] = False
    mask = np.ones((b, t), np.int32)
    mask[::2, 40:] = 0
    mask[1::2, 60:] = 0
    host = dict(img=rng.standard_normal((b, d), np.float32),
                txt=rng.standard_normal((b, d), np.float32),
                patches=rng.standard_normal((b, p, d), np.float32),
                tokens=rng.standard_normal((b, t, d), np.float32),
                pids=pids.astype(np.int32), valid=valid, mask=mask)
    fns = {
        "multi_positive_image_loss": lambda a: cl.multi_positive_image_loss(
            a["img"], a["pids"], a["valid"], 0.5),
        "multi_positive_image_loss_avg": lambda a: cl.multi_positive_image_loss_avg(
            a["img"], a["pids"], a["valid"], 0.5),
        "global_alignment_loss": lambda a: cl.global_alignment_loss(
            a["img"], a["txt"], a["pids"], a["valid"], 0.5),
        "local_token_alignment_loss": lambda a: cl.local_token_alignment_loss(
            a["patches"], a["tokens"], a["mask"], 0.5, valid=a["valid"]),
        "local_token_alignment_loss_no_mask": lambda a: cl.local_token_alignment_loss(
            a["patches"], a["tokens"], None, 0.5, valid=a["valid"]),
    }
    cpu_in = {k: torch.as_tensor(v) for k, v in host.items()}
    card_in = {k: v.to(dev) for k, v in cpu_in.items()}
    out = {}
    for name, fn in fns.items():
        want, got = float(fn(cpu_in)), float(fn(card_in))
        out[name] = dict(cpu=want, card=got, rel_err=abs(got - want) / abs(want))
    log("contrastive losses card vs CPU (float32, 64 images, D 2048, T 99, P 49): "
        + ", ".join(f"{k} {v['card']:.6f} (rel {v['rel_err']:.1e})" for k, v in out.items())
        + f"; tol {LOSS_TOL}")
    bad = {k: v for k, v in out.items() if not v["rel_err"] <= LOSS_TOL}
    if bad:
        raise AssertionError(f"contrastive losses card vs CPU: {bad}")
    return out


def retrieval_encode(vocab, dev, seed, smi):
    """Phase 10 (c): ``encode_images`` of the full-width pretrain model
    (bf16, eval path) over 4 batches in the loader's layout (64 anchors + 64
    aux views, uint8, 224 px), as ``cli retrieve`` runs it: flattened,
    float16, copied to the host."""
    from evoke_tpu_torch.models.pretrain import PretrainModel
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.steps import maybe_normalize_images

    with torch.device(dev):
        model = PretrainModel(vocab_size=vocab, dtype=torch.bfloat16)
    init_params_(model, seed).eval()
    rng = np.random.default_rng(seed + 31)
    batches = []
    for _ in range(4):
        bt = example_batch(rng, 64, 64, 224, 100, vocab)
        bt["images"] = rng.integers(0, 256, size=bt["images"].shape, dtype=np.uint8)
        batches.append({k: torch.as_tensor(bt[k]) for k in ("images", "pids", "valid")})

    @torch.inference_mode()
    def encode(bt):
        bt = maybe_normalize_images({k: v.to(dev, non_blocking=True) for k, v in bt.items()})
        proj, _ = model.encode_images(bt["images"], bt["pids"], bt["valid"], 64)
        return proj.reshape(64, -1).to(torch.float16).cpu()

    encode(batches[0])                     # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = [encode(bt) for bt in batches]
    wall = time.perf_counter() - t0
    emb = torch.cat(embs)
    out = dict(batches=4, studies=int(emb.shape[0]), dim=int(emb.shape[1]), wall_s=wall,
               ms_per_batch=wall / 4 * 1e3, studies_per_s=emb.shape[0] / wall,
               finite=bool(torch.isfinite(emb).all()))
    log(f"retrieval encode [{smi}]: 4 batches of 64 anchors + 64 aux at 224 px, bf16, eval "
        f"path: {out['ms_per_batch']:.1f} ms a batch, {out['studies_per_s']:.1f} studies/s, "
        f"embeddings {tuple(emb.shape)} float16 on the host")
    if not out["finite"] or out["dim"] != 50 * 2048:
        raise AssertionError(f"retrieval encode: {out}")
    del model
    torch.cuda.empty_cache()
    return out


def retrieval_search(dev, seed, smi, n=16384, d=50 * 2048, q=1024, k=20, chunk=4096,
                     n_check=64):
    """Phase 10 (c): ``TopKIndex.search`` (k 20) over a seeded float16
    database of ``n`` rows x ``d`` in pinned host memory, streamed to the
    card in chunks of ``chunk`` rows, with ``q`` queries (the database's
    first rows, each excluded from its own hits by its study code). Timed
    three times (median); the host -> device copy of the database is timed
    alone too. ``n_check`` queries are checked against a float64 search on
    the CPU: the ids must be equal wherever the float64 margin between the
    two candidates exceeds the sum of their float32 error bounds. A score's
    bound is 6 u sqrt(d / 2) ||q * x||_2: the float16 products are exact in
    float32, and with the rounding errors independent and the partial sums
    of these independent random terms growing as sqrt(k), the summation's
    error has a standard deviation under u sqrt(d / 2) ||q * x||_2 in any
    order (Higham and Mary's probabilistic model; 6 standard deviations).
    The largest error of a returned score is printed beside it."""
    from evoke_tpu_torch.retrieval.topk import NEG_INF, TopKIndex

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 41)
    db = torch.empty((n, d), dtype=torch.float16, pin_memory=True)
    for s in range(0, n, chunk):
        db[s:s + chunk].copy_(torch.randn((min(chunk, n - s), d), generator=g, device=dev,
                                          dtype=torch.float16))
    codes = np.arange(n, dtype=np.int64)
    ids = [str(i) for i in range(n)]
    index = TopKIndex(db, codes, ids, chunk_size=chunk, device=dev)
    queries = db[:q]
    set_up = time.perf_counter() - t0

    # the database's copy alone, chunk by chunk as the search streams it
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    buf = torch.empty((chunk, d), dtype=torch.float16, device=dev)
    start.record()
    for s in range(0, n, chunk):
        buf[:min(chunk, n - s)].copy_(db[s:s + chunk], non_blocking=True)
    end.record()
    end.synchronize()
    copy_ms = start.elapsed_time(end)
    del buf

    index.search(queries[:8], codes[:8], k)            # warm-up (cuBLAS, the sort)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores, idx = index.search(queries, codes[:q], k)
        walls.append(time.perf_counter() - t1)
    wall = statistics.median(walls)
    flops = 2.0 * q * n * d
    nbytes = index.h2d_bytes
    bound_ms = max(flops / PEAK_FLOPS[torch.float32], nbytes / LINK_BYTES_PER_S) * 1e3
    bound_by = ("operations" if flops / PEAK_FLOPS[torch.float32] >= nbytes / LINK_BYTES_PER_S
                else "bytes")

    # float64 check of the first n_check queries on the CPU
    t2 = time.perf_counter()
    q64 = queries[:n_check].double()
    s64 = torch.empty((n_check, n), dtype=torch.float64)
    sq_sum = torch.empty((n_check, n), dtype=torch.float64)
    for s in range(0, n, 1024):
        x = db[s:s + 1024].double()
        s64[:, s:s + 1024] = q64 @ x.t()
        sq_sum[:, s:s + 1024] = q64.square() @ x.square().t()
    err = 6.0 * FLOAT32_UNIT * math.sqrt(d / 2) * sq_sum.sqrt()   # a score's float32 bound
    s64[torch.arange(n_check), torch.arange(n_check)] = NEG_INF   # each query's own row
    ref = torch.sort(s64, dim=1, descending=True, stable=True).indices[:, :k + 1]
    got = torch.as_tensor(idx[:n_check])
    mismatched = excused = 0
    for r in range(n_check):
        for j in range(k):
            a, b = int(got[r, j]), int(ref[r, j])
            if a == b:
                continue
            mismatched += 1
            if abs(float(s64[r, a] - s64[r, b])) <= float(err[r, a] + err[r, b]):
                excused += 1
    # margins between neighbouring float64 candidates (top k + 1) under the bound
    ref_s = torch.gather(s64, 1, ref)
    ref_e = torch.gather(err, 1, ref)
    margins = ref_s[:, :-1] - ref_s[:, 1:]
    under = int((margins <= ref_e[:, :-1] + ref_e[:, 1:]).sum())
    score_err = (torch.as_tensor(scores[:n_check]).double() - torch.gather(s64, 1, got)).abs()
    worst = float(score_err.max())
    worst_vs_bound = float((score_err / torch.gather(err, 1, got)).max())
    check_s = time.perf_counter() - t2
    out = dict(rows=n, dim=d, queries=q, k=k, chunk=chunk, db_gib=db.numel() * 2 / 2 ** 30,
               set_up_s=set_up, wall_ms=wall * 1e3, walls_ms=[w * 1e3 for w in walls],
               rows_per_s=n / wall, pairs_per_s=n * q / wall, gemm_tflops=flops / wall / 1e12,
               h2d_bytes=nbytes, h2d_copy_ms=copy_ms, h2d_gb_per_s=nbytes / copy_ms / 1e6,
               bound_ms=bound_ms, bound_by=bound_by, checked_queries=n_check,
               float32_err_bound_median=float(err.median()),
               ids_mismatched=mismatched, mismatches_within_bound=excused,
               margins_under_bound=under, margins=int(margins.numel()),
               max_score_err=worst, max_score_err_over_bound=worst_vs_bound, check_s=check_s)
    log(f"retrieval search [{smi}]: k {k} over {n} x {d} float16 rows "
        f"({out['db_gib']:.2f} GiB, pinned host memory, chunks of {chunk}), {q} queries: "
        f"{out['wall_ms']:.1f} ms (median of 3), {out['rows_per_s']:.0f} rows/s "
        f"({out['pairs_per_s']:.3e} query-row products/s), GEMM {out['gemm_tflops']:.1f} "
        f"TFLOP/s float32; host -> device {nbytes / 1e9:.2f} GB, alone {copy_ms:.1f} ms "
        f"({out['h2d_gb_per_s']:.1f} GB/s); bound {bound_ms:.1f} ms ({bound_by}: "
        f"{flops / 1e12:.2f} TFLOP at {PEAK_FLOPS[torch.float32] / 1e12:.0f} TFLOP/s, "
        f"{nbytes / 1e9:.2f} GB at {LINK_BYTES_PER_S / 1e9:.0f} GB/s); float64 check of "
        f"{n_check} queries: float32 error bound (median) "
        f"{out['float32_err_bound_median']:.3f}, ids differing {mismatched} (within the "
        f"bound {excused}), neighbouring margins under the bound {under} of "
        f"{out['margins']}, largest score error {worst:.4f} ({worst_vs_bound:.2f} of its "
        f"bound); check {check_s:.1f}s")
    if excused != mismatched or not np.isfinite(scores).all():
        raise AssertionError(f"retrieval search: {out}")
    del index, db
    return out


def stage1_cli(root, seed, smi):
    """Phase 10 (d): the stage-1 chain through the CLI in-process, every
    default but bf16, over phase 9 (c)'s synthetic 224 px dataset (64 train
    / 16 val / 16 test studies, 30000 words): ``cli pretrain`` for 1 epoch,
    ``cli retrieve`` (k 20, no plots) from its ``current`` slot, then ``cli
    finetune`` over the augmented annotation seeded from that slot, 1 epoch.
    K1, K2 and K3 must launch 0 times."""
    import contextlib
    import io
    import os

    from evoke_tpu_torch import cli
    from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    t0 = time.perf_counter()
    ann = write_synthetic_dataset(root, n_train=64, n_val=16, n_test=16, image_size=224,
                                  seed=seed)
    tok_dir = write_cli_tokenizer(root, ann)
    data_s = time.perf_counter() - t0
    res = os.path.join(root, "results")
    argv = ["--data.image_dir", root, "--data.tokenizer_dir", tok_dir,
            "--trainer.result_dir", res, "--model.dtype", "bfloat16", "--trainer.epochs", "1"]
    slot = os.path.join(res, "mimic_cxr", "pretrain", "v1", "checkpoint", "current")
    aug = ann.replace(".json", "_best_reports_keywords_20.json")
    runs = [("pretrain", ["--data.ann_path", ann]),
            ("retrieve", ["--data.ann_path", ann, "--trainer.load", slot,
                          "--trainer.version", "retrieve"]),
            ("finetune", ["--data.ann_path", aug, "--trainer.load", slot])]
    lineage_attention.launches = 0
    fused_logit_topk.launches = 0
    masked_cross_view_attention.launches = 0
    walls, printed = {}, {}
    for task, extra in runs:
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([task] + argv + extra)
        torch.cuda.synchronize()
        walls[task] = time.perf_counter() - t1
        printed[task] = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {task} returned {rc}")
        gc_cuda()
    kernels = (lineage_attention.launches, fused_logit_topk.launches,
               masked_cross_view_attention.launches)
    pre_run = os.path.dirname(os.path.dirname(slot))
    ft_run = os.path.join(res, "mimic_cxr", "finetune", "v1")
    with open(os.path.join(pre_run, "metrics.jsonl")) as f:
        pre = [json.loads(line) for line in f]
    with open(os.path.join(ft_run, "finetune.log")) as f:
        ft_log = f.read()
    load_line = [line for line in ft_log.splitlines() if "partial load from" in line]
    with open(aug) as f:
        aug_ann = json.load(f)
    hits = [len(it["specific_knowledge"]["sk_ids"]) for split in ("train", "val", "test")
            for it in aug_ann[split]]
    problems = []
    if [r["epoch"] for r in pre] != [1] or not all(
            math.isfinite(pre[0][k]) for k in pre[0] if k.endswith("_loss")):
        problems.append(f"pretrain metrics {pre}")
    if not os.path.isfile(os.path.join(slot, "state.pt")):
        problems.append("no pretrain current slot")
    if not hits or any(h != 20 for h in hits):
        problems.append(f"sk_ids per study {sorted(set(hits))}")
    if not load_line:
        problems.append("finetune logged no partial load")
    if not os.path.isfile(os.path.join(ft_run, "test_prediction.csv")):
        problems.append("finetune wrote no test_prediction.csv")
    if any(kernels):
        problems.append(f"K1/K2/K3 launches {kernels}")
    report = load_line[0].split(": ", 1)[1] if load_line else ""
    out = dict(data_s=data_s, wall_s=walls, pretrain_losses={k: pre[0][k] for k in pre[0]
                                                               if k.endswith("_loss")},
               retrieve_printed=printed["retrieve"].strip().splitlines(),
               partial_load=report, studies_annotated=len(hits), launches_k1_k2_k3=kernels)
    log(f"cli pretrain -> retrieve -> finetune [{smi}]: 64 / 16 / 16 studies, bf16, 1 epoch "
        f"each: walls pretrain {walls['pretrain']:.1f} s, retrieve {walls['retrieve']:.1f} s, "
        f"finetune {walls['finetune']:.1f} s; pretrain val_all_loss "
        f"{pre[0].get('val_all_loss', float('nan')):.4f}; {len(hits)} studies annotated with "
        f"20 hits; finetune partial load {report}; K1/K2/K3 launches {kernels}; data "
        f"{data_s:.1f}s")
    if problems:
        raise AssertionError(f"stage-1 cli chain: {problems}")
    return out


# ---- phase 11: the decoder zoo, ViT-B/32, every decoding mode, heatmaps ----

ZOO_KINDS = ("causal", "bertgen", "cmn")
# phase 11 (c): each mode's DecodeConfig on the flagship, and its expected
# launches: K1 a decode step (diverse beam: a batch) and K2 a step
DECODE_MODES = (
    ("greedy trigram", dict(beam_size=1, sample_method="greedy", block_trigrams=True)),
    ("sample T0.7", dict(beam_size=1, sample_method="sample", temperature=0.7)),
    ("top_k 8", dict(beam_size=1, sample_method="top_k", top_k=8)),
    ("top_p 0.9", dict(beam_size=1, sample_method="top_p", top_p=0.9)),
    ("sample_n 3", dict(beam_size=1, sample_method="sample", sample_n=3)),
    ("diverse beam 6/2", dict(beam_size=6, group_size=2)),
    ("diverse sample 3", dict(beam_size=1, group_size=3, sample_method="sample")),
    ("int8 beam 3", dict(beam_size=3, kv_cache_dtype="int8", suppress_unk=True)),
)
SAMPLED = ("sample T0.7", "top_k 8", "top_p 0.9", "sample_n 3", "diverse sample 3")
# attention maps of the heatmaps, card vs CPU, float32 with TF32 off: the
# ResNet, fusion and decoder sum float32 products in other orders
HEATMAP_TOL = 1e-4


class StepCount:
    """Decode steps run by every loop class while active: each ``run``'s
    ``steps_run`` (global steps for the diverse loops) is added up."""

    def __enter__(self):
        from evoke_tpu_torch.decode import beam

        self.steps, self.runs, self._saved = 0, 0, []
        for cls in (beam.BeamLoop, beam.SampleLoop, beam.DiverseBeamLoop,
                    beam.DiverseSampleLoop):
            run = cls.run

            def counted(loop, _run=run):
                out = _run(loop)
                self.steps += loop.steps_run
                self.runs += 1
                return out

            self._saved.append((cls, run))
            cls.run = counted
        return self

    def __exit__(self, *exc):
        for cls, run in self._saved:
            cls.run = run


def zero_launches():
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    lineage_attention.launches = 0
    fused_logit_topk.launches = 0


def read_launches():
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    return lineage_attention.launches, fused_logit_topk.launches


def serve_one_batch(model, tok, cfg, batch, dev, what, max_len=100, profile=None,
                    repeats=3):
    """A ReportServer (captured) warmed on ``batch``, then ``batch`` served
    ``repeats`` times in one call (depth 2, as phase 4) with every launch
    count set to 0 first: the numbers, the warm-up's records, the records of
    the first repeat and the server. Every repeat must give the same reports
    (sampled modes reseed each batch), and launches and decode steps are
    given a batch. ``profile`` (the fragments of the hand-written kernels the
    path launches): one more batch under torch.profiler."""
    from evoke_tpu_torch.serve import ReportServer

    studies = len(batch["_image_ids"])
    server = ReportServer(model, tok, cfg, max_seq_len=max_len, depth=2, device=dev)
    warm = server.serve([batch], with_indication=True)
    capture_s = server.stats["capture_s"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with StepCount() as steps:
        records = server.serve([batch] * repeats, with_indication=True)
        torch.cuda.synchronize()
    n_k1, n_k2 = read_launches()
    gen = server._gen[True]
    if not all(loop.graphs for loop, _ in gen.loops.values()):
        raise AssertionError(f"{what}: the decode steps were not captured")
    if len(records) != repeats * studies or not all(r["report"].strip() for r in records):
        raise AssertionError(f"{what}: {len(records)} records or an empty report")
    first = records[:studies]
    if any(r["report"] != f["report"] for i in range(1, repeats)
           for r, f in zip(records[i * studies:(i + 1) * studies], first)):
        raise AssertionError(f"{what}: a repeat of the batch gave other reports")
    if n_k1 % repeats or n_k2 % repeats or steps.steps % repeats:
        raise AssertionError(f"{what}: launches {n_k1}, {n_k2} and steps {steps.steps} "
                             f"do not divide into {repeats} equal batches")
    out = dict(reports_per_s=server.stats["reports_per_s"], wall_s=server.stats["wall_s"],
               latency_p50_s=server.stats["batch_latency_p50_s"],
               latency_p90_s=server.stats["batch_latency_p90_s"], batches=repeats,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, capture_s=capture_s,
               launches_lineage=n_k1 // repeats, launches_fused=n_k2 // repeats,
               steps=steps.steps // repeats)
    if profile is not None:
        out["profile"] = profile_serving(lambda: server.serve([batch], with_indication=True),
                                         what=f"{what}, 1 batch", top=8, ported=profile)
    return out, warm, first, server


def float32_checks(model32, tok, cfg, small, dev, what, eval_path=True, max_len=100):
    """Two studies at float32: the serving path captured and eager must give
    the same tokens and scores bit for bit; with ``eval_path`` the eval path
    (reorder caches) must give the same best beams (token agreement printed,
    at least 0.9 as phase 3). Returns (agreement or None, serving tokens)."""
    from evoke_tpu_torch.train.steps import make_generate_step

    gens = [make_generate_step(model32, tok, cfg, max_len, with_indication=True,
                               serving=True, device=dev, graphs=graphs, all_samples=True)
            for graphs in (None, False)]
    cap, eag = (g(small) for g in gens)
    if not torch.equal(cap, eag):
        raise AssertionError(f"{what}: captured and eager tokens differ at float32")
    loops = [only_loop(g) for g in gens]
    if not (loops[0].graphs and not loops[1].graphs):
        raise AssertionError(f"{what}: captured / eager loops are not what was asked")
    for name in ("done_score", "logp_sum"):
        a, b = getattr(loops[0], name, None), getattr(loops[1], name, None)
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{what}: captured and eager {name} differ at float32")
    agree = None
    if eval_path:
        ev = make_generate_step(model32, tok, cfg, max_len, with_indication=True,
                                serving=False, device=dev, all_samples=True)(small)
        agree = float((ev[:, 0] == cap[:, 0]).float().mean())
        if agree < 0.9:
            raise AssertionError(f"{what}: serving vs eval path best beams agree {agree}")
    return agree, cap


def kept_set_check(model32, tok, mode_kw, small, dev, max_len=100):
    """A sampled mode at float32 on two studies, captured, trigram blocking
    off: a logits hook copies each step's log-probs into a static buffer;
    every token a row emits before its EOS must lie in that step's kept set
    (``decode/beam.filter_logits``). Returns the tokens checked."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.decode.beam import NEG_INF, filter_logits
    from evoke_tpu_torch.train.steps import make_generate_step, sampling_method

    cfg = DecodeConfig(**dict(mode_kw, block_trigrams=False))
    rows = 2 * max(int(cfg.sample_n), 1)
    vocab = tok.get_vocab_size() + 1
    rec = torch.empty(max_len, rows, vocab, device=dev)

    def hook(logp, tok_, pos, batch):
        rec[pos].copy_(logp)
        return logp

    gen = make_generate_step(model32, tok, cfg, max_len, with_indication=True, serving=True,
                             device=dev, logits_hook=hook, all_samples=True)
    seqs = gen(small).reshape(rows, max_len)
    if not only_loop(gen).graphs:
        raise AssertionError("kept-set check: the loop was not captured")
    method, top_k, top_p = sampling_method(cfg)
    checked = 0
    for t in range(max_len):
        kept = filter_logits(rec[t], method, float(cfg.temperature), top_k, top_p) > NEG_INF / 2
        for r in range(rows):
            if t and bool((seqs[r, :t] == tok.eos_id).any()):
                continue
            if not bool(kept[r, seqs[r, t]]):
                raise AssertionError(f"kept set: row {r} step {t} token {int(seqs[r, t])} "
                                     "outside it")
            checked += 1
    return checked


def loop_cache_bytes(gen):
    """Bytes of the self-attention caches (and int8 scales) of the longest
    cache phase of ``gen``'s one loop."""
    from evoke_tpu_torch.decode.beam import CACHE_KEYS, _leaves

    st = only_loop(gen)._phases[-1]
    return sum(t.numel() * t.element_size() for key in CACHE_KEYS if key in st
               for t in _leaves(st[key]))


def encode_ms(model, dev_batch, reps=5):
    """Median CUDA-event ms of ``encode_for_decode`` over one batch."""
    from evoke_tpu_torch.train.steps import maybe_normalize_images

    b = maybe_normalize_images(dev_batch)
    args = (b["images"], b["pids"], b["valid"], b["ids"].shape[0], b["inc_ids"],
            b["inc_mask"])
    times = []
    with torch.inference_mode():
        for i in range(reps + 1):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            model.encode_for_decode(*args)
            e.record()
            torch.cuda.synchronize()
            if i:
                times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase11_models(vocab, tok, dev, seed, smi, rng, studies=64, image_size=224,
                   max_len=100, with_profile=False):
    """Phase 11 (a)-(c): the decoder zoo, ViT-B/32 and every decoding mode at
    full width (bf16, one batch of ``studies`` studies each), with the
    float32 checks on two studies. Returns the numbers."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.data.batching import to_device

    out = {"zoo": {}, "modes": {}}
    batch = example_batch(rng, studies, studies, image_size, max_len, vocab)
    batch["_image_ids"] = [f"p11_s{j}" for j in range(studies)]
    small = {k: torch.as_tensor(v).to(dev) for k, v in example_batch(
        rng, 2, 2, image_size, max_len, vocab).items()}
    ml = dict(max_len=max_len)
    dev_batch, _ = to_device(batch, dev)
    beam3 = DecodeConfig(beam_size=3, suppress_unk=True)

    # (a) the decoder zoo on the flagship's encoder
    for kind in ZOO_KINDS:
        t0 = time.perf_counter()
        model = flagship(vocab, torch.bfloat16, dev, seed, decoder_kind=kind)
        rec, _, _, server = serve_one_batch(
            model, tok, beam3, batch, dev, f"zoo {kind}",
            profile=("lineage_kernel",) if with_profile else None, **ml)
        del server, model
        gc_cuda()
        if rec["steps"] <= 0 or rec["launches_lineage"] != 3 * rec["steps"] \
                or rec["launches_fused"] != 0:
            raise AssertionError(f"zoo {kind}: launches K1 {rec['launches_lineage']} K2 "
                                 f"{rec['launches_fused']} over {rec['steps']} steps "
                                 "(want K1 = 3 a step, K2 = 0)")
        model32 = flagship(vocab, torch.float32, dev, seed, decoder_kind=kind)
        rec["serving_vs_eval_agreement"], _ = float32_checks(model32, tok, beam3, small, dev,
                                                             f"zoo {kind}", **ml)
        del model32
        gc_cuda()
        rec["phase_s"] = time.perf_counter() - t0
        out["zoo"][kind] = rec
        log(f"phase 11 zoo {kind} [{smi}]: d 512 x 3, bf16, beam 3, 3 x {studies} studies "
            f"captured: "
            f"reports_per_s={rec['reports_per_s']:.2f} p50={rec['latency_p50_s']:.4f}s "
            f"p90={rec['latency_p90_s']:.4f}s wall={rec['wall_s']:.3f}s "
            f"peak_mem_gib={rec['peak_mem_gib']:.2f} capture_s={rec['capture_s']:.2f}; "
            f"launches a batch K1={rec['launches_lineage']} K2={rec['launches_fused']} over "
            f"{rec['steps']} steps; float32 2 studies: captured == eager (tokens, scores), "
            f"serving vs eval best-beam token agreement "
            f"{rec['serving_vs_eval_agreement']:.4f}; {rec['phase_s']:.1f}s")

    # (b) ViT-B/32 with the flagship's R2Gen decoder
    t0 = time.perf_counter()
    model = flagship(vocab, torch.bfloat16, dev, seed, visual_encoder="vit_b32")
    vit_ms = encode_ms(model, dev_batch)
    rec, _, _, server = serve_one_batch(model, tok, beam3, batch, dev, "vit_b32", **ml)
    del server, model
    gc_cuda()
    if rec["steps"] <= 0 or rec["launches_lineage"] != 3 * rec["steps"] \
            or rec["launches_fused"] != rec["steps"]:
        raise AssertionError(f"vit_b32: launches K1 {rec['launches_lineage']} K2 "
                             f"{rec['launches_fused']} over {rec['steps']} steps")
    model = flagship(vocab, torch.bfloat16, dev, seed)
    rec.update(encode_ms=vit_ms, resnet_encode_ms=encode_ms(model, dev_batch),
               phase_s=time.perf_counter() - t0)
    out["vit_b32"] = rec
    log(f"phase 11 vit_b32 [{smi}]: ViT-B/32 @ {image_size} + R2Gen, bf16, beam 3, "
        f"3 x {studies} studies "
        f"captured: encode {vit_ms:.2f} ms a batch (ResNet-101: "
        f"{rec['resnet_encode_ms']:.2f} ms), reports_per_s={rec['reports_per_s']:.2f} "
        f"p50={rec['latency_p50_s']:.4f}s p90={rec['latency_p90_s']:.4f}s wall="
        f"{rec['wall_s']:.3f}s peak_mem_gib={rec['peak_mem_gib']:.2f}; launches "
        f"a batch K1={rec['launches_lineage']} K2={rec['launches_fused']} over "
        f"{rec['steps']} steps")

    # (c) every decoding mode on the flagship (``model``: R2Gen, ResNet-101, bf16)
    model32 = flagship(vocab, torch.float32, dev, seed)
    tokens = {}
    for name, kw in DECODE_MODES:
        t0 = time.perf_counter()
        cfg = DecodeConfig(**kw)
        fragments = {"diverse beam 6/2": ("lineage_kernel",), "greedy trigram": (),
                     "int8 beam 3": PORTED_KERNELS[1:]}.get(name)
        rec, warm, records, server = serve_one_batch(
            model, tok, cfg, batch, dev, name,
            profile=fragments if with_profile else None, **ml)
        n_k1, n_k2, steps = rec["launches_lineage"], rec["launches_fused"], rec["steps"]
        if name.startswith("diverse beam"):
            ok = n_k1 == 2 * max_len * 3 and n_k2 == 0
        elif name.startswith("int8"):
            ok = n_k1 == 0 and n_k2 == steps > 0
        else:
            ok = n_k1 == 0 and n_k2 == 0
        if not ok:
            raise AssertionError(f"mode {name}: launches K1 {n_k1} K2 {n_k2} over {steps} "
                                 "steps")
        texts = [r["report"] for r in records]
        tokens[name] = texts
        if name in SAMPLED:
            gen = server._gen[True]
            if [r["report"] for r in warm] != texts:
                raise AssertionError(f"mode {name}: the same seed gave other tokens")
            gen.seed = 1
            other = server.serve([batch], with_indication=True)
            gen.seed = 0
            rec["other_seed_reports_differing"] = sum(
                a["report"] != b for a, b in zip(other, texts))
            if rec["other_seed_reports_differing"] == 0:
                raise AssertionError(f"mode {name}: another seed gave the same tokens")
            if name != "diverse sample 3":
                rec["kept_set_tokens_checked"] = kept_set_check(model32, tok, kw, small, dev,
                                                                **ml)
        elif name in ("greedy trigram", "diverse beam 6/2"):
            float32_checks(model32, tok, cfg, small, dev, name, eval_path=False, **ml)
        if name.startswith("int8"):
            rec["cache_bytes"] = loop_cache_bytes(server._gen[True])
            del server
            _, _, ref, server = serve_one_batch(
                model, tok, DecodeConfig(beam_size=3, suppress_unk=True, beam_kv="reorder"),
                batch, dev, "bf16 caches", **ml)
            rec["bf16_cache_bytes"] = loop_cache_bytes(server._gen[True])
            rec["token_agreement_with_bf16_caches"] = sum(
                a == b["report"] for a, b in zip(texts, ref)) / len(texts)
            pairs = [(a.split(), b["report"].split()) for a, b in zip(texts, ref)]
            rec["word_agreement_with_bf16_caches"] = sum(
                sum(x == y for x, y in zip(a, b)) for a, b in pairs) / sum(
                max(len(a), len(b)) for a, b in pairs)
            rec["first_difference_median"] = statistics.median(
                next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
                for a, b in pairs)
        del server
        gc_cuda()
        rec["phase_s"] = time.perf_counter() - t0
        out["modes"][name] = rec
        extra = ""
        if name in SAMPLED:
            extra = (f"; same seed twice: equal; seed 1: "
                     f"{rec['other_seed_reports_differing']}/{studies} reports differ")
            if "kept_set_tokens_checked" in rec:
                extra += (f"; float32 2 studies captured: "
                          f"{rec['kept_set_tokens_checked']} tokens in their kept sets")
        elif name in ("greedy trigram", "diverse beam 6/2"):
            extra = "; float32 2 studies: captured == eager"
        elif name.startswith("int8"):
            extra = (f"; caches {rec['cache_bytes'] / 2 ** 20:.2f} MiB (bf16 "
                     f"{rec['bf16_cache_bytes'] / 2 ** 20:.2f} MiB); reports equal to the "
                     f"bf16-cache run (reorder) {rec['token_agreement_with_bf16_caches']:.4f}, "
                     f"words in place {rec['word_agreement_with_bf16_caches']:.4f}, first "
                     f"differing word (median) {rec['first_difference_median']}")
        log(f"phase 11 mode {name} [{smi}]: 3 x {studies} studies captured: reports_per_s="
            f"{rec['reports_per_s']:.2f} p50={rec['latency_p50_s']:.4f}s p90="
            f"{rec['latency_p90_s']:.4f}s wall={rec['wall_s']:.3f}s peak_mem_gib="
            f"{rec['peak_mem_gib']:.2f} capture_s={rec['capture_s']:.2f}; launches a batch "
            f"K1={n_k1} K2={n_k2} over {steps} steps{extra}; {rec['phase_s']:.1f}s")
    del model, model32
    gc_cuda()
    return out


def heatmaps_cli(root, ann, tok_dir, has_ind, no_ind, smi, extra=(), devices=("cuda", "cpu")):
    """Phase 11 (d): ``cli test --trainer.plot_heatmaps 2`` in-process over
    phase 7's dataset and configuration (bf16). The PNG count must equal the
    decoder layers times the words of the studies drawn; the attention maps
    of a float32 copy of the CLI's weights on the card must match the same
    on the CPU (the drawn studies and their views) within ``HEATMAP_TOL``."""
    import contextlib
    import io
    import os

    from evoke_tpu_torch import cli
    from evoke_tpu_torch.evals import heatmaps

    drawn, built = [], []
    render, build = heatmaps.render_generation_heatmaps, cli.build_model

    def recording_render(model, batch, seqs, tokenizer, out_dir, num_layers, **kw):
        paths = render(model, batch, seqs, tokenizer, out_dir, num_layers, **kw)
        drawn.append(dict(model=model, batch=batch, seqs=seqs, n=kw["max_studies"],
                          tok=tokenizer, layers=num_layers, paths=paths,
                          with_indication=kw["with_indication"]))
        return paths

    def recording_build(cfg, *a, **kw):
        built.append(cfg)
        return build(cfg, *a, **kw)

    heatmaps.render_generation_heatmaps, cli.build_model = recording_render, recording_build
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["test", "--data.ann_path", ann, "--data.image_dir", root,
                           "--data.tokenizer_dir", tok_dir,
                           "--trainer.result_dir", os.path.join(root, "results"),
                           "--trainer.version", "heatmaps", "--model.dtype", "bfloat16",
                           "--trainer.plot_heatmaps", "2", *extra])
        torch.cuda.synchronize()
    finally:
        heatmaps.render_generation_heatmaps, cli.build_model = render, build
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli test --trainer.plot_heatmaps returned {rc}")
    out_dir = os.path.join(root, "results", "mimic_cxr", "test", "heatmaps", "attentions")
    pngs = [os.path.join(d, f) for d, _, fs in os.walk(out_dir) for f in fs
            if f.endswith(".png")]
    want = 0
    for d in drawn:
        for i in range(d["n"]):
            row = d["seqs"][i].tolist()
            ends = [j for j, t in enumerate(row) if t in (d["tok"].pad_id, d["tok"].eos_id)]
            want += d["layers"] * (ends[0] if ends else len(row))
    if len(pngs) != want or sum(len(d["paths"]) for d in drawn) != want or not want:
        raise AssertionError(f"heatmaps: {len(pngs)} PNGs, want {want}")

    # the attention maps, card vs CPU, of a float32 copy of the weights
    cfg = built[-1]
    cfg.model.dtype = "float32"
    d = drawn[0]
    sd = {k: v.float() for k, v in d["model"].state_dict().items()}
    n = d["n"]
    b = {k: v for k, v in d["batch"].items()}
    keep = [i for i in range(b["images"].shape[0]) if i < n or (
        i >= b["ids"].shape[0] and 0 <= int(b["pids"][i]) < n and bool(b["valid"][i]))]
    sub = {k: (v[keep] if k in ("images", "pids", "valid") else v[:n]) for k, v in b.items()}
    seqs = d["seqs"][:n]
    maps = {}
    for where in devices:
        model = build(cfg, d["tok"].get_vocab_size(), torch.device(where))
        model.load_state_dict(sd)
        model.eval()
        batch = {k: v.to(where) for k, v in sub.items()}
        maps[where] = attention_maps(model, batch, seqs, d["tok"], d["with_indication"])
        del model
    card, host = (maps[w] for w in devices)
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(card, host))
    gc_cuda()
    if not err <= HEATMAP_TOL:
        raise AssertionError(f"heatmaps: attention maps card vs cpu {err} > {HEATMAP_TOL}")
    res = dict(cli_wall_s=wall, pngs=len(pngs), studies=sum(x["n"] for x in drawn),
               attention_max_abs_err=err)
    log(f"phase 11 cli test --trainer.plot_heatmaps 2 [{smi}]: {len(pngs)} PNGs "
        f"({res['studies']} studies x {drawn[0]['layers']} layers x their words), cli wall "
        f"{wall:.1f}s; "
        f"float32 attention maps card vs cpu max abs err {err:.3e} (tol {HEATMAP_TOL})")
    return res


def attention_maps(model, batch, seqs, tok, with_indication):
    """The decoder layers' recorded cross-attention [n, h, T, P] of the
    teacher-forced forward that ``evals/heatmaps`` draws."""
    from evoke_tpu_torch.evals.heatmaps import cross_attention_modules, recorded_attention
    from evoke_tpu_torch.train.steps import maybe_normalize_images

    b = maybe_normalize_images(batch)
    dev = b["ids"].device
    bos = np.full((seqs.shape[0], 1), tok.bos_id, seqs.dtype)
    ids = np.concatenate([bos, seqs[:, :-1]], axis=1)
    mask = np.concatenate([bos * 0 + 1, seqs[:, :-1] != tok.pad_id], axis=1).astype(np.int32)
    args = [b["images"], torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
            b["pids"], b["valid"]]
    if with_indication:
        args += [b["inc_ids"], b["inc_mask"]]
    with torch.no_grad(), recorded_attention(cross_attention_modules(model)) as rec:
        model(*args, train=False)
    return [r[0] for r in rec]


# ---- phase 12: an EVOKE checkpoint imported and served ----

# JAX's report counts for EVOKE's layout at the flagship's widths: every
# tensor but the BatchNorm counters and BERT's pooler loads, none is
# mismatched or missing (tests/test_torch_port_torch_import.py holds the
# port's importer to JAX's on this layout at the tiny widths)
IMPORT_MISMATCHED, IMPORT_MISSING = 0, 0


def native_tokenizer_check(ann, tok_dir, smi):
    """Phase 12 (d), run over phase 7's dataset: the port's native library
    built with g++ (a failed build fails), its WordLevel encoder against the
    Python WordTokenizer on every report of the annotation."""
    import os

    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.data.tokenizer import WordTokenizer
    from evoke_tpu_torch.native import NativeWordLevel, build_native

    t0 = time.perf_counter()
    path = build_native()
    if path is None:
        raise AssertionError("phase 12: g++ failed to build the native library")
    build_s = time.perf_counter() - t0
    tok = WordTokenizer.from_file(os.path.join(
        tok_dir, "mimic_cxr_wordlevel_uncased_tokenizer.json"))
    texts = [r["report"] for split in load_annotation(ann).values() for r in split]
    nat = NativeWordLevel(tok.vocab, tok.unk_id)
    t0 = time.perf_counter()
    got = nat.encode_padded_batch(texts, 100, tok.pad_id)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.stack([tok.encode_padded(t, 100) for t in texts])
    python_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError(f"phase 12 native tokenizer: {(got != want).any(1).sum()} of "
                             f"{len(texts)} reports differ from WordTokenizer")
    log(f"phase 12 native [{smi}]: g++ build {build_s:.1f}s ({os.path.basename(path)}); "
        f"NativeWordLevel == WordTokenizer on {len(texts)} reports x 100 tokens (native "
        f"{native_s * 1e3:.1f} ms, Python {python_s * 1e3:.1f} ms)")
    return dict(build_s=build_s, reports=len(texts), native_ms=native_s * 1e3,
                python_ms=python_s * 1e3)


def bits_differ(a, b):
    """Elements of ``a`` and ``b`` (one dtype, on the card) whose bits differ,
    as a device tensor."""
    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return (a.view(view) != b.view(view)).sum()


def imported_checkpoint(vocab, tok, cfg, dev, seed, smi, rng):
    """Phase 12 (a)-(c) and the digest of (d). Returns the phase's numbers."""
    import copy
    import os

    from evoke_tpu_torch.core.profiling import capture_trace, format_summary, summarize_trace
    from evoke_tpu_torch.models import torch_import
    from evoke_tpu_torch.models.evoke_layout import evoke_to_port_key, finetune_state_dict
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.train.steps import make_generate_step

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as root:
        # (a) the checkpoint
        t0 = time.perf_counter()
        sd = finetune_state_dict(seed, vocab)
        out["fabricate_s"] = time.perf_counter() - t0
        path = os.path.join(root, "model_best.pth")
        t0 = time.perf_counter()
        torch.save({"state_dict": sd}, path)
        out["save_s"] = time.perf_counter() - t0
        out["file_gib"] = os.path.getsize(path) / 2 ** 30
        out["tensors"] = len(sd)
        out["params"] = sum(v.numel() for v in sd.values())
        log(f"phase 12 checkpoint: {len(sd)} tensors, {out['params'] / 1e6:.1f} M values, "
            f"{out['file_gib']:.3f} GiB (drawn {out['fabricate_s']:.1f}s, torch.save "
            f"{out['save_s']:.1f}s)")

        # (b) load into a freshly initialised bf16 flagship on the card
        model = flagship(vocab, torch.bfloat16, dev, seed + 1)
        real_load, load_s = torch.load, []

        def timed_load(*a, **kw):
            t = time.perf_counter()
            blob = real_load(*a, **kw)
            load_s.append(time.perf_counter() - t)
            return blob

        torch.load = timed_load
        try:
            t0 = time.perf_counter()
            _, report = torch_import.load_finetune_checkpoint(path, model)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
        finally:
            torch.load = real_load
    out.update(load_s=load_s[0], import_s=total_s - load_s[0], report=report)
    mapped = {k: evoke_to_port_key(k) for k in sd}
    n_mapped = sum(m is not None for m in mapped.values())
    target = model.state_dict()
    want = {"loaded": n_mapped, "mismatched": IMPORT_MISMATCHED, "missing": IMPORT_MISSING}
    if report != want or n_mapped != len(target):
        raise AssertionError(f"phase 12 import report {report}, want {want} and every one of "
                             f"the model's {len(target)} tensors")
    t0 = time.perf_counter()
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    elements = 0
    for k, m in mapped.items():
        if m is None:
            continue
        src = sd[k].to(dev)
        src = src[..., 0] if m[1] else src
        dst = target[m[0]]
        differ += bits_differ(dst, src.to(torch.float32).to(dst.dtype))
        elements += dst.numel()
    differ = int(differ)
    out["compare_s"] = time.perf_counter() - t0
    log(f"phase 12 import [{smi}]: torch.load {out['load_s']:.2f}s, import into the card's "
        f"bf16 flagship {out['import_s']:.2f}s; report {report}; {n_mapped} tensors "
        f"({elements} elements) compared bit for bit on the card after the cast: {differ} "
        f"differ ({out['compare_s']:.2f}s)")
    if differ:
        raise AssertionError(f"phase 12: {differ} imported elements differ from the checkpoint")

    # (c) serve one batch of 64 studies
    batch = example_batch(rng, 64, 64, 224, 100, vocab)
    batch["_image_ids"] = [f"p12_s{j}" for j in range(64)]
    masked_cross_view_attention.launches = 0
    served, _, _, server = serve_one_batch(model, tok, cfg, batch, dev, "phase 12")
    n_k3 = masked_cross_view_attention.launches
    out.update(served, launches_fusion=n_k3)
    log(f"phase 12 serve [{smi}]: imported flagship, bf16, beam 3, 3 x 64 studies captured: "
        f"reports_per_s={served['reports_per_s']:.1f} p50={served['latency_p50_s']:.3f}s "
        f"peak={served['peak_mem_gib']:.2f}GiB capture={served['capture_s']:.2f}s "
        f"K1={served['launches_lineage']} K2={served['launches_fused']} K3={n_k3} a batch")
    if (served["launches_lineage"], served["launches_fused"], n_k3) != (300, 100, 0):
        raise AssertionError(f"phase 12 launches K1 {served['launches_lineage']}, K2 "
                             f"{served['launches_fused']}, K3 {n_k3}: want 300, 100, 0")

    # (d) the trace digest around the same batch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        t0 = time.perf_counter()
        capture_trace(lambda: server.serve([batch], with_indication=True), tdir)
        digest = summarize_trace(tdir)
        out["trace_s"] = time.perf_counter() - t0
    loop_names = [r["name"] for r in digest["loop_ops"]]
    k1_ops = [r for r in digest["loop_ops"] if "lineage_kernel" in r["name"]]
    log(f"phase 12 digest [{smi}] ({out['trace_s']:.1f}s with the export):\n"
        + format_summary(digest, top=8))
    if not k1_ops:
        raise AssertionError(f"phase 12 digest: no lineage_kernel among {len(loop_names)} "
                             f"loop ops {loop_names[:10]}")
    out["digest"] = dict(loop_total_us=digest["loop_total_us"],
                         oneshot_total_us=digest["oneshot_total_us"],
                         lineage_kernel=[dict(name=r["name"], count=r["count"],
                                              total_us=r["total_us"]) for r in k1_ops])
    del server, model, target
    gc_cuda()

    # (c) float32: the same tensors, card against the CPU, 2 studies
    model32 = flagship(vocab, torch.float32, dev, seed + 1)
    _, report32 = torch_import.import_finetune_checkpoint(sd, model32)
    if report32 != want:
        raise AssertionError(f"phase 12 float32 import report {report32}")
    small = example_batch(rng, 2, 2, 224, 100, vocab)
    seqs = {}
    t0 = time.perf_counter()
    for where, m in (("card", model32), ("cpu", copy.deepcopy(model32).cpu())):
        d = dev if where == "card" else torch.device("cpu")
        gen = make_generate_step(m, tok, cfg, 100, with_indication=True, serving=True, device=d)
        seqs[where] = gen({k: torch.as_tensor(v).to(d) for k, v in small.items()}).cpu()
        del gen, m
    out["float32_s"] = time.perf_counter() - t0
    same = torch.equal(seqs["card"], seqs["cpu"])
    out["float32_best_beams_equal"] = same
    log(f"phase 12 float32 [{smi}]: best beams of 2 studies card vs CPU identical {same} "
        f"({seqs['card'].unique().numel()} distinct tokens, {out['float32_s']:.1f}s)")
    if not same or seqs["card"].unique().numel() <= 3:
        raise AssertionError(f"phase 12: float32 best beams card vs CPU differ, or are "
                             f"trivial: {seqs}")
    del model32, sd
    gc_cuda()
    return out


# ---- phase 13: data parallelism over torch.distributed ----

# two ranks share the one card: NCCL refuses that, so they run gloo on CUDA
# tensors, chosen here explicitly (the port never falls back to gloo)
DP_DEVICES = ("cuda:0", "cuda:0")
DP_PARAM_TOL = 6.5e-5      # phase 9 (b)'s card-vs-CPU bound, on parameters after one step


def dp_one_rank_group():
    """A real NCCL process group of size 1 in this process (the CLI's
    ``--decode.serve_dp`` joins it, as it joins torchrun's)."""
    from evoke_tpu_torch.core.mesh import init_distributed, rendezvous_file

    init_distributed("nccl", rendezvous_file(), 1, 0, device="cuda")


def dp_serve_cli(root, data, single, smi):
    """Phase 13 (a): ``cli serve --decode.serve_dp -1`` (one rank on the one
    card, NCCL) on both engines, in the 1-rank group: the CSV must be
    phase 6's row for row and the K1 / K2 counts phase 6's."""
    out = {}
    for engine, base in single.items():
        res = serve_cli(root, *data, engine=engine, serve_dp=-1)
        if "serving mesh: dp=1" not in res["printed"]:
            raise AssertionError(f"phase 13 (a) {engine}: no 'serving mesh: dp=1' line")
        if res["csv_rows"] != base["csv_rows"]:
            raise AssertionError(f"phase 13 (a) {engine}: serve_prediction.csv differs from "
                                 "the one-device CLI's")
        counts = (res["launches_lineage"], res["launches_fused"])
        if counts != (base["launches_lineage"], base["launches_fused"]):
            raise AssertionError(f"phase 13 (a) {engine}: launches {counts}, one device "
                                 f"{(base['launches_lineage'], base['launches_fused'])}")
        for r in (res, base):
            r.pop("csv_rows")
            r.pop("printed")
        log(f"phase 13 (a) cli serve --decode.serve_dp -1 --decode.engine {engine} [{smi}]: "
            f"serving mesh: dp=1 (NCCL, 1 rank), CSV == one device's row for row; "
            f"reports_per_s={res['reports_per_s']} (one device {base['reports_per_s']}), "
            f"without the capture {res['reports_per_s_without_capture']:.3f} (one device "
            f"{base['reports_per_s_without_capture']:.3f}), p50 "
            f"{res.get('batch_latency_p50_s', res.get('study_p50_ms'))} (one device "
            f"{base.get('batch_latency_p50_s', base.get('study_p50_ms'))}), launches "
            f"lineage={counts[0]} fused={counts[1]} (== one device's)")
        out[engine] = res
    return out


def dp_dryrun(smi):
    """Phase 13 (d): ``evoke_tpu_torch.dryrun``'s 5 stages on the card at
    world size 1, in the 1-rank NCCL group (each stage prints its line)."""
    from evoke_tpu_torch import dryrun
    from evoke_tpu_torch.core.mesh import MeshSpec, create_mesh

    t0 = time.perf_counter()
    zero_launches()
    dryrun.run(create_mesh(MeshSpec(dp=1), device="cuda"))
    n_k1, n_k2 = read_launches()
    log(f"phase 13 (d) dryrun 1 [{smi}]: 5 stages in {time.perf_counter() - t0:.1f}s, "
        f"launches lineage={n_k1} fused={n_k2}")
    return dict(seconds=time.perf_counter() - t0, launches_lineage=n_k1, launches_fused=n_k2)


def _rank_result(mesh, out_dir, name, result):
    """Every rank's ``result`` -> ``out_dir/name.json`` (rank 0 writes)."""
    import os

    from evoke_tpu_torch.parallel.collectives import gather_objects

    parts = gather_objects(result, mesh)
    if mesh.rank == 0:
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(parts, f)


def dp_serve_rank(mesh, out_dir, seed):
    """Phase 13 (b), one of two ranks on the one card: the float32 flagship
    decodes 2 studies a rank through ``make_generate_step(mesh=)`` (the
    gathered best beams must be the one-device serving path's, which rank 0
    decodes too); then the bf16 flagship serves one 64-study batch through
    ``ReportServer(mesh=)``, 32 studies a rank, captured, after a warm-up."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.decode.forcing import synthetic_tokenizer
    from evoke_tpu_torch.parallel.collectives import all_gather_batch
    from evoke_tpu_torch.serve import ReportServer
    from evoke_tpu_torch.train.steps import make_generate_step

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tok = synthetic_tokenizer(30000)
    vocab = tok.get_vocab_size()
    cfg = DecodeConfig(beam_size=3, suppress_unk=True)
    rng = np.random.default_rng(seed + 13)
    small = example_batch(rng, 2 * mesh.dp, 2 * mesh.dp, 224, 100, vocab)
    model32 = flagship(vocab, torch.float32, dev, seed)
    gen = make_generate_step(model32, tok, cfg, 100, with_indication=True, serving=True,
                             device=dev, mesh=mesh)
    seqs = all_gather_batch(gen(shard_batch(small, mesh)), mesh).cpu()
    same = None
    if mesh.rank == 0:
        one = make_generate_step(model32, tok, cfg, 100, with_indication=True, serving=True,
                                 device=dev)
        want = one({k: torch.as_tensor(v).to(dev) for k, v in small.items()}).cpu()
        same = bool(torch.equal(seqs, want))
        if not same:
            raise AssertionError(f"phase 13 (b): dp float32 best beams differ from one "
                                 f"device's in {int((seqs != want).sum())} tokens")
        del one
    del gen, model32
    gc_cuda()
    model = flagship(vocab, torch.bfloat16, dev, seed)
    batch = example_batch(rng, 64, 64, 224, 100, vocab)
    batch["_image_ids"] = [f"dp_s{j}" for j in range(64)]
    server = ReportServer(model, tok, cfg, max_seq_len=100, depth=2, mesh=mesh)
    server.serve([batch], with_indication=True)
    capture_s = server.stats["capture_s"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with StepCount() as steps:
        records = server.serve([batch], with_indication=True)
        torch.cuda.synchronize()
    n_k1, n_k2 = read_launches()
    (b, *_), = [key for key in server._gen[True].loops]
    if len(records) != 64 or not all(r["report"].strip() for r in records):
        raise AssertionError(f"phase 13 (b) rank {mesh.rank}: {len(records)} records")
    if n_k1 != 3 * steps.steps or n_k2 != steps.steps or not steps.steps:
        raise AssertionError(f"phase 13 (b) rank {mesh.rank}: K1 {n_k1}, K2 {n_k2} over "
                             f"{steps.steps} decode steps (want 3 and 1 a step)")
    _rank_result(mesh, out_dir, "dp_serve", dict(
        rank=mesh.rank, float32_best_beams_equal=same, studies=b, k2_rows=b * cfg.beam_size,
        steps=steps.steps, launches_lineage=n_k1, launches_fused=n_k2,
        reports_per_s=server.stats["reports_per_s"],
        latency_p50_s=server.stats["batch_latency_p50_s"], capture_s=capture_s,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30))


def mesh_train_step(model, batch, task, mesh, seed, lr):
    """One train step (RAdam at ``lr``, dropout on) of ``model`` under
    ``mesh`` (None: one rank) -> (loss, name -> parameter)."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    opt = build_optimizer("RAdam", task, model, **lr)
    step = make_train_step(model, opt, seed, with_indication=task == "finetune",
                           task=task, mesh=mesh)
    model.train()
    out = step(TrainState(model, opt), batch)
    return float(out["all_loss"]), {n: p.detach() for n, p in model.named_parameters()}


def mesh_update_err(task, before, got, want, lr):
    """The worst ratio of a mesh step's update's distance from the one-rank
    update to its bound (tests/test_torch_port_parallel.py's): RAdam's
    first step moves a weight by lr times its gradient clipped to +-0.1,
    so 1e-3 of that outside the ResNet, 2e-2 in L2 norm relative inside
    it (its batch-statistics BatchNorms amplify the sums' rounding);
    and how many parameters the one-rank step moved."""
    from evoke_tpu_torch.train.optim import param_label

    worst, moved = 0.0, 0
    for n, w in want.items():
        d_want, d_got = w - before[n], got[n] - before[n]
        moved += bool(d_want.abs().max() > 0)
        err = d_got - d_want
        ulp = 2 * torch.finfo(torch.float32).eps * w.abs()   # the step's own rounding
        if n.startswith("visual_extractor"):
            ratio = err.norm() / (2e-2 * d_want.norm() + ulp.norm() + 1e-30)
        else:
            lr_n = lr["ft_lr" if task == "finetune" and param_label(n) == "ft" else "pt_lr"]
            ratio = (err.abs() / (1e-3 * 0.1 * lr_n + ulp)).max()
        worst = max(worst, float(ratio))
    return worst, moved


def dp_train_rank(mesh, out_dir, seed):
    """Phase 13 (c), one of two ranks on the one card: the TINY float32
    finetune and pretrain steps (phase 9 (b) / 10 (b)'s models; dropout on,
    the config's learning rates) on the rank's rows against the one-rank step
    on the global batch, parameters bit-identical across the ranks (a
    checksum); then the full-width bf16 finetune step at 16 + 16 a rank."""
    import copy
    import hashlib

    from evoke_tpu_torch.core.config import OptimConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.parallel.collectives import gather_objects
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = OptimConfig()
    lr = dict(pt_lr=o.pt_lr, ft_lr=o.ft_lr, weight_decay=o.weight_decay)
    result = dict(rank=mesh.rank)

    rng = np.random.default_rng(seed + 11)
    bt = example_batch(rng, 2, 2, 64, 16, 50)
    bt["mask"][1, 12:] = 0
    for task in ("finetune", "pretrain"):
        model = tiny_train_model(seed=seed, task=task).to(dev)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        want_loss, want = mesh_train_step(copy.deepcopy(model), {
            k: torch.as_tensor(v).to(dev) for k, v in bt.items()}, task, None, seed, lr)
        loss, got = mesh_train_step(model, shard_batch(bt, mesh), task, mesh, seed, lr)
        loss_err = abs(loss - want_loss) / abs(want_loss)
        param_err = max((got[n] - want[n]).abs().max().item() for n in want)
        upd_ratio, moved = mesh_update_err(task, before, got, want, lr)
        digest = hashlib.sha256(b"".join(got[n].cpu().numpy().tobytes()
                                         for n in sorted(got))).hexdigest()
        digests = gather_objects(digest, mesh)
        if (loss_err > 1e-5 or param_err > DP_PARAM_TOL or upd_ratio > 1.0
                or moved <= len(want) // 2 or len(set(digests)) != 1):
            raise AssertionError(f"phase 13 (c) {task} rank {mesh.rank}: loss {loss} vs "
                                 f"{want_loss} (rel {loss_err:.2e}), parameters {param_err:.2e}"
                                 f", update error {upd_ratio:.2f} of its bound, {moved} of "
                                 f"{len(want)} parameters moved, checksums {digests}")
        result[task] = dict(loss=loss, loss_one_rank=want_loss, loss_rel_err=loss_err,
                            param_max_abs_err=param_err, update_err_of_bound=upd_ratio,
                            moved=moved, n_params=len(want), checksum=digest[:16])
        del model
    gc_cuda()
    vocab, n_anchor, image_size, seq = 30001, 32, 224, 100
    with torch.device(dev):
        model = FinetuneModel(vocab_size=vocab, max_seq_len=seq, dtype=torch.bfloat16)
    init_params_(model, seed)
    opt = build_optimizer(o.optim, "finetune", model, pt_lr=o.pt_lr, ft_lr=o.ft_lr,
                          weight_decay=o.weight_decay, grad_clip_value=o.grad_clip_value)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, seed, with_indication=True, mesh=mesh)
    rng = np.random.default_rng(seed + 5)
    full = example_batch(rng, n_anchor, n_anchor, image_size, seq, vocab)
    full["images"] = rng.integers(0, 256, size=full["images"].shape, dtype=np.uint8)
    full["mask"][:, seq * 3 // 5:] = 0
    full["mask"][::2, seq * 2 // 5:] = 0
    batch = shard_batch(full, mesh)
    model.train()
    zero_launches()
    masked_cross_view_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(8):
        t1 = time.perf_counter()
        losses.append(float(step(state, batch)["lm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    kernels = read_launches() + (masked_cross_view_attention.launches,)
    if any(kernels) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 13 (c) full width rank {mesh.rank}: K1/K2/K3 {kernels}, "
                             f"losses {losses}")
    result["full_width"] = dict(
        rows=int(batch["ids"].shape[0]), step_ms=statistics.median(times[3:]) * 1e3,
        step_ms_all=[t * 1e3 for t in times], peak_mem_gib=torch.cuda.max_memory_allocated()
        / 2 ** 30, losses=losses, launches_k1_k2_k3=kernels)
    _rank_result(mesh, out_dir, "dp_train", result)


def dp_two_ranks(seed, smi):
    """Phase 13 (b) and (c): two ranks spawned on the one card (gloo on CUDA
    tensors); each phase's per-rank numbers are printed here."""
    import os

    from evoke_tpu_torch.core.mesh import spawn

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as d:
        for name, body in (("dp_serve", dp_serve_rank), ("dp_train", dp_train_rank)):
            gc_cuda()
            t0 = time.perf_counter()
            spawn(body, 2, (d, seed), devices=DP_DEVICES, backend="gloo",
                  init_method="file://" + os.path.join(d, f"{name}.rendezvous"),
                  timeout_s=300)
            with open(os.path.join(d, f"{name}.json")) as f:
                out[name] = json.load(f)
            out[name + "_s"] = time.perf_counter() - t0
    for r in out["dp_serve"]:
        log(f"phase 13 (b) dp=2 on one card (gloo), rank {r['rank']} [{smi}]: bf16 flagship "
            f"{r['studies']} of 64 studies, K2 rows {r['k2_rows']}, {r['steps']} decode steps, "
            f"launches lineage={r['launches_lineage']} fused={r['launches_fused']}, "
            f"reports_per_s={r['reports_per_s']:.2f} (all 64 reports over this rank's wall; "
            f"two ranks share the card: information, not a speed), p50 "
            f"{r['latency_p50_s']:.3f}s, capture {r['capture_s']:.2f}s, peak_mem_gib="
            f"{r['peak_mem_gib']:.2f}" + (f"; float32 best beams of 4 studies == one device: "
                                         f"{r['float32_best_beams_equal']}"
                                         if r["rank"] == 0 else ""))
    for r in out["dp_train"]:
        fw = r["full_width"]
        log(f"phase 13 (c) dp=2 train step on one card (gloo), rank {r['rank']} [{smi}]: "
            + "; ".join(f"TINY {t} loss {r[t]['loss']:.6f} vs one rank "
                        f"{r[t]['loss_one_rank']:.6f} (rel {r[t]['loss_rel_err']:.1e}), "
                        f"parameters {r[t]['param_max_abs_err']:.1e} (tol {DP_PARAM_TOL}), "
                        f"update error {r[t]['update_err_of_bound']:.3f} of its bound, "
                        f"{r[t]['moved']} of {r[t]['n_params']} parameters moved, "
                        f"checksum {r[t]['checksum']}" for t in ("finetune", "pretrain"))
            + f"; full width bf16 {fw['rows']} + {fw['rows']} a rank: step_ms="
            f"{fw['step_ms']:.1f} (median of 5 after 3 warm-up), peak_mem_gib="
            f"{fw['peak_mem_gib']:.2f}, K1/K2/K3 {fw['launches_k1_k2_k3']}")
    sums = [[r[t]["checksum"] for r in out["dp_train"]] for t in ("finetune", "pretrain")]
    if any(len(set(c)) != 1 for c in sums):
        raise AssertionError(f"phase 13 (c): parameter checksums differ across ranks: {sums}")
    return out


# ---- phase 14: tensor parallelism over torch.distributed ----

# the ranks share the one card over gloo, as phase 13's do
TP_DEVICES = ("cuda:0",) * 4


def tp_param_bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tp_fusion_rank(mesh, seed):
    """Phase 14 (a), one of two ranks (mp=2): the wide fusion module at
    phase 5's layout (d 2048, wide qkv, 8 heads, T 50, 64 anchors / 128
    images, bf16), kernel route, sharded over mp: K3 runs on the rank's 4
    heads (its launches counted), the module's output against the one-device
    module's, and K3 on the rank's heads against its plain version."""
    from evoke_tpu_torch.models.fusion import BatchedCrossViewAttention, same_study_matrix
    from evoke_tpu_torch.ops.fusion_attention import (masked_cross_view_attention,
                                                      masked_cross_view_attention_plain)
    from evoke_tpu_torch.parallel.tp import shard_params_tp
    from evoke_tpu_torch.params import init_params_

    dev, dtype = mesh.device, torch.bfloat16
    d, heads, t, n_anchor = 2048, 8, 50, 64
    pids_np, attend_np = partner_layout(n_anchor)
    pids = torch.as_tensor(pids_np, device=dev)
    valid = torch.ones(len(pids_np), dtype=torch.bool, device=dev)
    study = same_study_matrix(pids[:n_anchor], pids, valid[:n_anchor], valid)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 14)
    x = torch.randn(len(pids_np), t, d, generator=g, device=dev).to(dtype)
    with torch.device(dev):
        m = init_params_(BatchedCrossViewAttention(d, heads, wide_qkv=True), seed)
        tpm = BatchedCrossViewAttention(d, heads, wide_qkv=True, use_pallas=True, dtype=dtype)
    tpm.load_state_dict(m.state_dict())
    del m
    with torch.inference_mode():
        one = tpm(x[:n_anchor], x, study).float()       # one device (a comparison launch)
    shard_params_tp(tpm, mesh)
    masked_cross_view_attention.launches = 0
    with torch.inference_mode():
        got = tpm(x[:n_anchor], x, study).float()
    torch.cuda.synchronize()
    n_k3 = masked_cross_view_attention.launches
    err = (got - one).abs().max().item()
    # K3 on this rank's heads, as the module calls it, against its plain version
    h = tpm.num_heads
    with torch.inference_mode():
        q = tpm.fc_q(x[:n_anchor]).reshape(n_anchor, t, h, d).transpose(1, 2)
        k = tpm.fc_k(x).reshape(-1, h, d).transpose(0, 1)
        v = tpm.fc_v(x).reshape(-1, h, d).transpose(0, 1)
        attend = torch.as_tensor(attend_np, device=dev)
        kern = masked_cross_view_attention(q, k, v, attend, t)
        plain = masked_cross_view_attention_plain(q, k, v, attend, t)
    torch.cuda.synchronize()
    k3_err = (kern.float() - plain.float()).abs().max().item()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    ms = time_ms(lambda: masked_cross_view_attention(q, k, v, attend, t), flush, reps=5,
                 device_only=True)
    plain_ms = time_ms(lambda: masked_cross_view_attention_plain(q, k, v, attend, t), flush,
                       reps=3, device_only=True)
    if h != heads // mesh.mp or n_k3 < 1:
        raise AssertionError(f"phase 14 (a) rank {mesh.rank}: {h} heads a rank, K3 launched "
                             f"{n_k3} times")
    if not err <= FUSION_TOL[dtype] or not k3_err <= K3_TOL[dtype]:
        raise AssertionError(f"phase 14 (a) rank {mesh.rank}: module vs one device {err} "
                             f"(tol {FUSION_TOL[dtype]}), K3 vs plain {k3_err} "
                             f"(tol {K3_TOL[dtype]})")
    return dict(heads=h, launches_fusion_attention=n_k3, module_vs_one_device=err,
                k3_vs_plain=k3_err, k3_device_only_ms=ms, plain_device_only_ms=plain_ms)


def tp_serve_rank(mesh, seed):
    """Phase 14 (b), one of two ranks (mp=2): the float32 flagship's best
    beams of 4 studies at mp=2 (eager: the steps hold mp collectives; K1 and
    K2 declined) against one device's decode on the same routes (rank 0
    decodes it before sharding); then the
    bf16 flagship sharded at mp=2 serves one 64-study batch through
    ``ReportServer(mesh=)``, eager, after a warm-up: reports/s, peak GiB, the
    rank's parameter bytes beside one device's, K1 = K2 = K3 = 0."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.decode.forcing import synthetic_tokenizer
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.parallel.tp import shard_params_tp
    from evoke_tpu_torch.serve import ReportServer
    from evoke_tpu_torch.train.steps import make_generate_step

    dev = mesh.device
    tok = synthetic_tokenizer(30000)
    vocab = tok.get_vocab_size()
    cfg = DecodeConfig(beam_size=3, suppress_unk=True)
    rng = np.random.default_rng(seed + 14)
    small = example_batch(rng, 4, 4, 224, 100, vocab)
    model32 = flagship(vocab, torch.float32, dev, seed)
    want = kernels = None
    if mesh.rank == 0:
        # one device's eval path (reorder caches, the unfused tail: the routes the
        # mp=2 path takes), and its serving path through K1 and K2 for agreement
        dev_small = {k: torch.as_tensor(v).to(dev) for k, v in small.items()}
        want, kernels = (make_generate_step(model32, tok, cfg, 100, with_indication=True,
                                            serving=serving, device=dev)(dev_small).cpu()
                         for serving in (False, True))
    shard_params_tp(model32, mesh)
    gen = make_generate_step(model32, tok, cfg, 100, with_indication=True, serving=True,
                             device=dev, mesh=mesh)
    seqs = gen(shard_batch(small, mesh)).cpu()
    same = agree = None
    if want is not None:
        same = bool(torch.equal(seqs, want))
        agree = float((seqs == kernels).float().mean())
    if same is False:
        raise AssertionError(f"phase 14 (b): mp=2 float32 best beams differ from one device's "
                             f"in {int((seqs != want).sum())} tokens")
    if gen.captured or gen.ancestor_kv or gen.fused_topk:
        raise AssertionError("phase 14 (b): the mp=2 decode captured its steps or kept K1 / K2")
    del gen, model32
    gc_cuda()
    model = flagship(vocab, torch.bfloat16, dev, seed)
    one_bytes = tp_param_bytes(model)
    shard_params_tp(model, mesh)
    rank_bytes = tp_param_bytes(model)
    gc_cuda()
    batch = example_batch(rng, 64, 64, 224, 100, vocab)
    batch["_image_ids"] = [f"tp_s{j}" for j in range(64)]
    server = ReportServer(model, tok, cfg, max_seq_len=100, depth=2, mesh=mesh)
    server.serve([batch], with_indication=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    masked_cross_view_attention.launches = 0
    with StepCount() as steps:
        records = server.serve([batch], with_indication=True)
        torch.cuda.synchronize()
    n_k1, n_k2 = read_launches()
    n_k3 = masked_cross_view_attention.launches
    if len(records) != 64 or not all(r["report"].strip() for r in records):
        raise AssertionError(f"phase 14 (b) rank {mesh.rank}: {len(records)} records")
    if (n_k1, n_k2, n_k3) != (0, 0, 0) or server.stats["captured"] or not steps.steps:
        raise AssertionError(f"phase 14 (b) rank {mesh.rank}: K1/K2/K3 {(n_k1, n_k2, n_k3)}, "
                             f"captured {server.stats['captured']}, {steps.steps} steps")
    return dict(float32_best_beams_equal=same, float32_agreement_with_kernels=agree,
                studies=64, steps=steps.steps,
                launches_lineage=n_k1, launches_fused=n_k2, launches_fusion_attention=n_k3,
                captured=server.stats["captured"], reports_per_s=server.stats["reports_per_s"],
                latency_p50_s=server.stats["batch_latency_p50_s"],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                param_bytes_rank=rank_bytes, param_bytes_one_device=one_bytes,
                param_share=rank_bytes / one_bytes)


def tp_full_train_rank(mesh, seed):
    """Phase 14 (c), full width, one of two ranks (mp=2): the bf16 flagship
    finetune step (RAdam, batch 16 + 16, the config's optimizer) sharded at
    mp=2: ms a step and peak GiB a rank, finite losses, no K1 / K2 / K3."""
    from evoke_tpu_torch.core.config import OptimConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.ops.fusion_attention import masked_cross_view_attention
    from evoke_tpu_torch.parallel.tp import shard_params_tp
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    dev = mesh.device
    o = OptimConfig()
    vocab, n_anchor, image_size, seq = 30001, 16, 224, 100
    with torch.device(dev):
        model = FinetuneModel(vocab_size=vocab, max_seq_len=seq, dtype=torch.bfloat16)
    init_params_(model, seed)
    shard_params_tp(model, mesh)
    gc_cuda()
    opt = build_optimizer(o.optim, "finetune", model, pt_lr=o.pt_lr, ft_lr=o.ft_lr,
                          weight_decay=o.weight_decay, grad_clip_value=o.grad_clip_value)
    state = TrainState(model, opt)
    step = make_train_step(model, opt, seed, with_indication=True, mesh=mesh)
    rng = np.random.default_rng(seed + 5)
    full = example_batch(rng, n_anchor, n_anchor, image_size, seq, vocab)
    full["images"] = rng.integers(0, 256, size=full["images"].shape, dtype=np.uint8)
    full["mask"][:, seq * 3 // 5:] = 0
    full["mask"][::2, seq * 2 // 5:] = 0
    batch = shard_batch(full, mesh)
    model.train()
    zero_launches()
    masked_cross_view_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(5):
        t1 = time.perf_counter()
        losses.append(float(step(state, batch)["lm"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    kernels = read_launches() + (masked_cross_view_attention.launches,)
    if any(kernels) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 14 (c) full width rank {mesh.rank}: K1/K2/K3 {kernels}, "
                             f"losses {losses}")
    return dict(rows=n_anchor, step_ms=statistics.median(times[2:]) * 1e3,
                step_ms_all=[t * 1e3 for t in times],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, losses=losses,
                launches_k1_k2_k3=kernels)


def tp_mp2_rank(mesh, out_dir, seed):
    """Phase 14 (a), (b) and the full-width step of (c) on one of two ranks
    (dp=1 x mp=2) sharing the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = dict(rank=mesh.rank, fusion=tp_fusion_rank(mesh, seed))
    gc_cuda()
    result["serve"] = tp_serve_rank(mesh, seed)
    gc_cuda()
    result["full_width"] = tp_full_train_rank(mesh, seed)
    _rank_result(mesh, out_dir, "tp_mp2", result)


def tp_tiny_train_rank(mesh, out_dir, seed):
    """Phase 14 (c), one of four ranks (dp=2 x mp=2): the TINY float32
    finetune and pretrain steps (phase 13 (c)'s models and bounds) sharded
    over mp on the rank's rows against the one-rank step on the global batch;
    replicated parameters bit-identical on every rank (a checksum), and the
    gathered parameters too."""
    import copy
    import hashlib

    from evoke_tpu_torch.core.config import OptimConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.parallel.collectives import gather_objects
    from evoke_tpu_torch.parallel.tp import full_state_dict, shard_params_tp, split_dims

    dev = mesh.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    o = OptimConfig()
    lr = dict(pt_lr=o.pt_lr, ft_lr=o.ft_lr, weight_decay=o.weight_decay)
    result = dict(rank=mesh.rank)
    rng = np.random.default_rng(seed + 11)
    bt = example_batch(rng, 2, 2, 64, 16, 50)
    bt["mask"][1, 12:] = 0

    def checksum(tensors):
        return hashlib.sha256(b"".join(tensors[n].cpu().numpy().tobytes()
                                       for n in sorted(tensors))).hexdigest()

    for task in ("finetune", "pretrain"):
        model = tiny_train_model(seed=seed, task=task).to(dev)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        want_loss, want = mesh_train_step(copy.deepcopy(model), {
            k: torch.as_tensor(v).to(dev) for k, v in bt.items()}, task, None, seed, lr)
        shard_params_tp(model, mesh)
        loss, local = mesh_train_step(model, shard_batch(bt, mesh), task, mesh, seed, lr)
        split = split_dims(model)
        full = {n: t for n, t in full_state_dict(model).items() if n in want}
        loss_err = abs(loss - want_loss) / abs(want_loss)
        param_err = max((full[n] - want[n]).abs().max().item() for n in want)
        upd_ratio, moved = mesh_update_err(task, before, full, want, lr)
        sums = gather_objects((checksum({n: t for n, t in local.items() if n not in split}),
                               checksum(full)), mesh)
        if (loss_err > 1e-5 or param_err > DP_PARAM_TOL or upd_ratio > 1.0
                or moved <= len(want) // 2 or len(set(sums)) != 1):
            raise AssertionError(f"phase 14 (c) {task} rank {mesh.rank}: loss {loss} vs "
                                 f"{want_loss} (rel {loss_err:.2e}), parameters {param_err:.2e}"
                                 f", update error {upd_ratio:.2f} of its bound, {moved} of "
                                 f"{len(want)} parameters moved, checksums {sums}")
        result[task] = dict(loss=loss, loss_one_rank=want_loss, loss_rel_err=loss_err,
                            param_max_abs_err=param_err, update_err_of_bound=upd_ratio,
                            moved=moved, n_params=len(want), n_split=len(split),
                            checksum=sums[0][0][:16])
        del model
    _rank_result(mesh, out_dir, "tp_tiny", result)


def tp_ranks(seed, smi):
    """Phase 14 (a)-(c): two ranks (dp=1 x mp=2) and four (dp=2 x mp=2)
    spawned on the one card over gloo; (d) the dry run at 4 ranks there. The
    per-rank numbers are printed here."""
    import os

    from evoke_tpu_torch import dryrun
    from evoke_tpu_torch.core.mesh import MeshSpec, spawn

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as d:
        for name, body, spec in (("tp_mp2", tp_mp2_rank, MeshSpec(dp=1, mp=2)),
                                 ("tp_tiny", tp_tiny_train_rank, MeshSpec(dp=2, mp=2))):
            gc_cuda()
            t0 = time.perf_counter()
            spawn(body, args=(d, seed), spec=spec, devices=TP_DEVICES[:spec.n_devices],
                  backend="gloo", init_method="file://" + os.path.join(d, f"{name}.rdzv"),
                  timeout_s=400)
            with open(os.path.join(d, f"{name}.json")) as f:
                out[name] = json.load(f)
            out[name + "_s"] = time.perf_counter() - t0
    for r in out["tp_mp2"]:
        a, b, c = r["fusion"], r["serve"], r["full_width"]
        log(f"phase 14 (a) mp=2 on one card (gloo), rank {r['rank']} [{smi}]: wide fusion "
            f"bf16 (d 2048, T 50, Q 64, B 128) on {a['heads']} of 8 heads, K3 launched "
            f"{a['launches_fusion_attention']}x, module vs one device max_abs_err="
            f"{a['module_vs_one_device']:.3e} (tol {FUSION_TOL[torch.bfloat16]}), K3 vs plain "
            f"{a['k3_vs_plain']:.3e} (tol {K3_TOL[torch.bfloat16]}); K3 on 4 heads "
            f"{a['k3_device_only_ms']:.4f} ms, plain {a['plain_device_only_ms']:.4f} ms "
            f"(device-only; two ranks share the card)")
        log(f"phase 14 (b) mp=2 on one card (gloo), rank {r['rank']} [{smi}]: bf16 flagship "
            f"64 studies, {b['steps']} decode steps, eager (captured={b['captured']}), "
            f"reports_per_s={b['reports_per_s']:.2f} (two ranks share the card and gloo goes "
            f"through the host: information, not a speed), p50 {b['latency_p50_s']:.3f}s, "
            f"peak_mem_gib={b['peak_mem_gib']:.2f}, parameter bytes {b['param_bytes_rank']} "
            f"of one device's {b['param_bytes_one_device']} ({100 * b['param_share']:.1f}%), "
            f"launches lineage={b['launches_lineage']} fused={b['launches_fused']} "
            f"fusion_attention={b['launches_fusion_attention']}"
            + (f"; float32 best beams of 4 studies == one device's eval path (reorder, "
               f"unfused): {b['float32_best_beams_equal']}, token agreement with its K1 + K2 "
               f"serving path {b['float32_agreement_with_kernels']:.4f}"
               if r["rank"] == 0 else ""))
        log(f"phase 14 (c) mp=2 full-width bf16 train step on one card (gloo), rank "
            f"{r['rank']} [{smi}]: {c['rows']} + {c['rows']} studies, step_ms="
            f"{c['step_ms']:.1f} (median of 3 after 2 warm-up), peak_mem_gib="
            f"{c['peak_mem_gib']:.2f}, K1/K2/K3 {c['launches_k1_k2_k3']}, losses "
            f"{[round(x, 4) for x in c['losses']]}")
    for r in out["tp_tiny"]:
        log(f"phase 14 (c) dp=2 x mp=2 TINY train steps on one card (gloo), rank {r['rank']} "
            f"[{smi}]: " + "; ".join(
                f"{t} loss {r[t]['loss']:.6f} vs one rank {r[t]['loss_one_rank']:.6f} (rel "
                f"{r[t]['loss_rel_err']:.1e}), parameters {r[t]['param_max_abs_err']:.1e} (tol "
                f"{DP_PARAM_TOL}), update error {r[t]['update_err_of_bound']:.3f} of its bound, "
                f"{r[t]['moved']} of {r[t]['n_params']} moved, {r[t]['n_split']} split, "
                f"checksum {r[t]['checksum']}" for t in ("finetune", "pretrain")))
    t0 = time.perf_counter()
    dryrun.dryrun(4, devices=list(TP_DEVICES), backend="gloo", timeout_s=300)
    out["dryrun_s"] = time.perf_counter() - t0
    log(f"phase 14 (d) dryrun 4 (dp=2 x mp=2, 4 ranks on one card, gloo) [{smi}]: 5 stages "
        f"in {out['dryrun_s']:.1f}s")
    return out


def gc_cuda():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def flagship(vocab_size, dtype, dev, seed, **kw):
    """__graft_entry__._flagship(vocab_size) at full width, seeded random
    weights; ``kw`` (decoder_kind, visual_encoder) swaps a part."""
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.params import init_params_

    with torch.device(dev):
        model = FinetuneModel(vocab_size=vocab_size, max_seq_len=100, fusion_max_partners=3,
                              dtype=dtype, **kw)
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
                         "(and in phase 8 two loader batches through the continuous "
                         "engine; in phase 11 one batch of each zoo decoder, greedy, "
                         "diverse beam and int8) and print device busy share, the top "
                         "kernels and each hand-written kernel's total")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs the card",
              file=sys.stderr)
        sys.exit(2)

    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.decode.forcing import synthetic_tokenizer
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
    small_np = example_batch(rng, 2, 2, 224, 100, vocab)
    small = {k: torch.as_tensor(v).to(dev) for k, v in small_np.items()}
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
    cont = ContinuousServer(model32, synthetic_tokenizer(vocab, spell_ids=True), max_seq_len=100,
                            slots=2, beam_size=3, suppress_unk=True, device=dev)
    c_recs, _ = cont.serve([dict(small_np, _image_ids=["a", "b"])])
    s_cont = spelled_tokens(c_recs, 100, tok.pad_id)
    agree_cont = float((s_cont == s_kern).mean())
    if not (cont.loop.graphs and cont.ancestor_kv and cont.fused_topk):
        raise AssertionError("phase 3: the continuous engine did not capture its loop, or "
                             "left the kernels' route")
    del cont
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
        f"token agreement {agree:.4f}; continuous engine (2 slots, ring caches) vs the "
        f"serving path: token agreement {agree_cont:.4f}; {time.perf_counter() - t0:.1f}s")
    if not (same_tok and same_score):
        raise AssertionError("the captured loop disagrees with the eager loop at float32")
    if agree < 0.9:
        raise AssertionError(f"serving path disagrees with the eval path: {agree}")
    if agree_cont < 0.9:
        raise AssertionError(f"continuous engine disagrees with the serving path: {agree_cont}")
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
        cli_cont = serve_cli(root, *data, engine="continuous")
        # phase 13 (a) and (d) run here, in a 1-rank NCCL group over phase 6's dataset
        t0 = time.perf_counter()
        dp_one_rank_group()
        try:
            p13 = {"serve_dp_cli": dp_serve_cli(root, data, {"batch": cli_res,
                                                             "continuous": cli_cont}, smi),
                   "dryrun": dp_dryrun(smi)}
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
        log(f"phase 13 (a), (d) {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        test_res = test_cli(root, *data, smi, args.seed)
        log(f"test cli phase {time.perf_counter() - t0:.1f}s")
        # phase 11 (d) runs here, over phase 7's dataset
        t0 = time.perf_counter()
        heat = heatmaps_cli(root, *data, smi)
        log(f"phase 11 (d) heatmaps {time.perf_counter() - t0:.1f}s")
        # phase 12 (d)'s native check runs here, over phase 7's dataset
        native = native_tokenizer_check(data[0], data[1], smi)

    # ---- phase 8: the continuous engine against the batch engine, forced lengths ----
    t0 = time.perf_counter()
    model = flagship(vocab, torch.bfloat16, dev, args.seed)
    engines = continuous_engine(model, cfg, vocab, dev, args.seed, smi, args.profile)
    del model
    torch.cuda.empty_cache()
    log(f"continuous engine phase {time.perf_counter() - t0:.1f}s")

    # ---- phase 9: finetune training ----
    t0 = time.perf_counter()
    train_full = train_step_full_width(vocab, dev, args.seed, smi, args.profile)
    train_check = train_card_vs_cpu(dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_finetune_") as root:
        finetune = finetune_cli(root, args.seed, smi)
    log(f"finetune phase {time.perf_counter() - t0:.1f}s")

    # ---- phase 10: stage-1 pretraining and knowledge retrieval ----
    t0 = time.perf_counter()
    pretrain_full = train_step_full_width(vocab, dev, args.seed, smi, args.profile,
                                          task="pretrain")
    pretrain_check = train_card_vs_cpu(dev, args.seed, task="pretrain")
    losses_check = contrastive_losses_card_vs_cpu(dev, args.seed)
    encode = retrieval_encode(vocab, dev, args.seed, smi)
    search = retrieval_search(dev, args.seed, smi)
    gc_cuda()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stage1_") as root:
        stage1 = stage1_cli(root, args.seed, smi)
    log(f"pretrain and retrieval phase {time.perf_counter() - t0:.1f}s")

    # ---- phase 11: the decoder zoo, ViT-B/32 and every decoding mode ----
    t0 = time.perf_counter()
    p11 = phase11_models(vocab, tok, dev, args.seed, smi, rng, with_profile=args.profile)
    p11["heatmaps"] = heat
    log(f"phase 11 (a)-(c) {time.perf_counter() - t0:.1f}s")
    p11_k1 = {f"zoo {k}": r["launches_lineage"] for k, r in p11["zoo"].items()}
    p11_k1.update({"vit_b32": p11["vit_b32"]["launches_lineage"]},
                  **{k: r["launches_lineage"] for k, r in p11["modes"].items()})
    p11_k2 = {f"zoo {k}": r["launches_fused"] for k, r in p11["zoo"].items()}
    p11_k2.update({"vit_b32": p11["vit_b32"]["launches_fused"]},
                  **{k: r["launches_fused"] for k, r in p11["modes"].items()})

    # ---- phase 12: an EVOKE checkpoint imported and served ----
    t0 = time.perf_counter()
    p12 = imported_checkpoint(vocab, tok, cfg, dev, args.seed, smi, rng)
    p12["native"] = native
    log(f"phase 12 {time.perf_counter() - t0:.1f}s")

    # ---- phase 13 (b), (c): two ranks on the one card ----
    t0 = time.perf_counter()
    p13.update(dp_two_ranks(args.seed, smi))
    log(f"phase 13 (b), (c) {time.perf_counter() - t0:.1f}s")
    p13_counts = {}
    for i, key in enumerate(("launches_lineage", "launches_fused", "launches_fusion_attention")):
        counts = {f"cli serve_dp -1 {engine}": r.get(key, 0)
                  for engine, r in p13["serve_dp_cli"].items()}
        counts.update({f"dp=2 serve rank {r['rank']}": r.get(key, 0) for r in p13["dp_serve"]})
        counts.update({f"dp=2 train rank {r['rank']}": r["full_width"]["launches_k1_k2_k3"][i]
                       for r in p13["dp_train"]})
        counts["dryrun 1"] = p13["dryrun"].get(key, 0)
        p13_counts[key] = counts

    # ---- phase 14: tensor parallelism, two and four ranks on the one card ----
    t0 = time.perf_counter()
    p14 = tp_ranks(args.seed, smi)
    log(f"phase 14 {time.perf_counter() - t0:.1f}s")
    p14_counts = {}
    for i, key in enumerate(("launches_lineage", "launches_fused", "launches_fusion_attention")):
        counts = {}
        for r in p14["tp_mp2"]:
            counts[f"mp=2 fusion rank {r['rank']}"] = r["fusion"].get(key, 0)
            counts[f"mp=2 serve rank {r['rank']}"] = r["serve"][key]
            counts[f"mp=2 train rank {r['rank']}"] = r["full_width"]["launches_k1_k2_k3"][i]
        p14_counts[key] = counts

    line_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    main1, main2, main3 = ({key: rec[key] for key in line_keys} for rec in (
        k1[(torch.bfloat16, 100, False)], k2[(torch.bfloat16, (4,), 192)],
        k3[(torch.bfloat16, 64)]))
    kernels = {"kernels": [
        dict(name="lineage_attention", route="cuda",
             source="evoke_tpu_torch/csrc/lineage_attention.cu",
             replaces="evoke_tpu/ops/lineage_attention.py:213", launches=n_k1, **main1,
             launches_phase11=p11_k1, launches_phase12=p12["launches_lineage"],
             launches_phase13=p13_counts["launches_lineage"],
             launches_phase14=p14_counts["launches_lineage"]),
        dict(name="fused_logit_topk", route="cuda",
             source="evoke_tpu_torch/csrc/fused_logit_topk.cu",
             replaces="evoke_tpu/ops/fused_logit_topk.py:147", launches=n_k2, **main2,
             launches_phase11=p11_k2, launches_phase12=p12["launches_fused"],
             launches_phase13=p13_counts["launches_fused"],
             launches_phase14=p14_counts["launches_fused"]),
        dict(name="masked_cross_view_attention", route="cuda",
             source="evoke_tpu_torch/csrc/fusion_attention.cu",
             replaces="evoke_tpu/ops/fusion_attention.py:86", launches=n_k3, **main3,
             launches_phase11={}, launches_phase12=p12["launches_fusion"],
             launches_phase13=p13_counts["launches_fusion_attention"],
             launches_phase14=p14_counts["launches_fusion_attention"]),
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
            "cli_serve": cli_res, "cli_serve_continuous": cli_cont, "cli_test": test_res,
            "engines": engines, "continuous_token_agreement": agree_cont,
            "main_path": dict(st, reference_token_agreement=agree),
            "main_path_runs": runs, "main_path_set_up": set_up,
            "decode_step_wall_ms": step_wall, "early_stop": early,
            "finetune": {"train_step": train_full, "card_vs_cpu": train_check,
                         "cli": finetune},
            "pretrain": {"train_step": pretrain_full, "card_vs_cpu": pretrain_check,
                         "losses_card_vs_cpu": losses_check, "retrieval_encode": encode,
                         "retrieval_search": search, "cli": stage1},
            "phase11": p11, "phase12": p12, "phase13": p13, "phase14": p14,
            "kernels": kernels["kernels"],
            "profile": profile,
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
