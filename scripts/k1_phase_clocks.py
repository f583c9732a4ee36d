"""Where K1's time goes inside a block: a measuring build of
csrc/lineage_attention.cu (-DLINEAGE_PHASE_CLOCKS) in which thread 0 of every
block stamps the SM's cycle counter and the card's nanosecond timer at the end
of each phase, run at the serving shape (64 samples x beam 3, d 512, 8 heads,
bf16, batch mode at pos = L - 1) after a 64 MB L2-evicting memset:

    python3 scripts/k1_phase_clocks.py [--lengths 13 50 100] [--reps 20]

Per cache length and lineage kind (random; converged: one shared ancestor row
in every slot but the last 5) it prints one JSON line: the median over blocks
and launches of each phase's microseconds (cycles over the SM clock that
nvidia-smi reports under load), the median block's whole time, and from the
nanosecond timer the launch's span (first block's start to last block's end)
and how late the 95th-percentile block starts after the first. The stamps cost
a few stores a block; the main path's build has none of this.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("mask_and_list", "v_request", "k_pass", "softmax", "v_wait", "p_v", "output")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", type=int, nargs="+", default=[13, 50, 100])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        sys.exit("k1_phase_clocks: needs the card")
    from evoke_tpu_torch.ops import _build
    from evoke_tpu_torch.ops import lineage_attention as la

    lib = ctypes.CDLL(str(_build.build("lineage_attention",
                                      ("-DLINEAGE_PHASE_CLOCKS",))))
    lib.lineage_attention_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.lineage_attention_phase_clocks.restype = ctypes.c_int
    fn = la.bind(lib)
    la._lib = lambda: fn          # the wrapper launches the measuring build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    b, kbeam, d, heads = 64, 3, 512, 8
    blocks = b * heads
    stamps = torch.zeros(2, blocks, 8, dtype=torch.int64, device=dev)
    if lib.lineage_attention_phase_clocks(stamps.data_ptr()) != 0:
        sys.exit("k1_phase_clocks: could not set the stamp buffer")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for lmax in args.lengths:
        for lineage in ("random", "converged"):
            q = torch.randn(b * kbeam, d, generator=g, device=dev).bfloat16()
            ck = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
            cv = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
            anc = torch.randint(0, kbeam, (b, kbeam, lmax), generator=g, device=dev,
                                dtype=torch.int32)
            if lineage == "converged":
                anc[:, :, :max(lmax - 5, 0)] = torch.randint(
                    0, kbeam, (b, 1, 1), generator=g, device=dev, dtype=torch.int32)
            cycles, nanos, mhz = [], [], []
            for rep in range(args.reps + 1):
                flush.zero_()
                la.lineage_attention(q, ck, cv, anc, lmax - 1, heads)
                torch.cuda.synchronize()
                if rep == 0:
                    continue                      # warm-up
                cycles.append(stamps[0].clone())
                nanos.append(stamps[1].clone())
                if rep % 5 == 0:
                    mhz.append(float(subprocess.run(
                        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                        capture_output=True, text=True).stdout.split()[0]))
            cyc = torch.stack(cycles).double()             # [reps, blocks, 8]
            ns = torch.stack(nanos).double()
            sm_mhz = sorted(mhz)[len(mhz) // 2]
            per_phase = (cyc[..., 1:] - cyc[..., :-1]).reshape(-1, 7).median(0).values / sm_mhz
            start = ns[..., 0] - ns[..., 0].min(1, keepdim=True).values
            out = {"L": lmax, "lineage": lineage, "sm_mhz": sm_mhz,
                   "attended_rows": int(la.attended_rows(anc, lmax - 1).sum()),
                   "phase_us": {name: round(float(v), 3) for name, v in zip(PHASES, per_phase)},
                   "block_us": round(float(((cyc[..., 7] - cyc[..., 0]) / sm_mhz).median()), 3),
                   "span_us": round(float(((ns[..., 7].max(1).values
                                            - ns[..., 0].min(1).values) / 1e3).median()), 3),
                   "start_p95_us": round(float(start.quantile(0.95, dim=1).median() / 1e3), 3)}
            print(json.dumps(out), flush=True)
    lib.lineage_attention_phase_clocks(None)


if __name__ == "__main__":
    main()
