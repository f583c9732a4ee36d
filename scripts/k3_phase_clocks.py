"""Where K3's time goes inside a block: a measuring build of
csrc/fusion_attention.cu (-DFUSION_PHASE_CLOCKS) in which thread 0 of every
block of the cluster route stamps the SM's cycle counter and the card's
nanosecond timer at the end of each phase of its first exchange (a pair of
32-key tiles) and around the output, run at the fusion module's shapes (T 50, 8 heads, dk 2048, bf16
and float32, flagship layout Q 64 / B 128: anchors attend 1, 1, 3, 1 samples)
after a 64 MB L2-evicting memset:

    python3 scripts/k3_phase_clocks.py [--reps 10] [--anchors 64]

Per dtype it prints one JSON line: the median over blocks and launches of each
phase's microseconds (cycles over the SM clock that nvidia-smi reports under
load), split by the number of samples the block's anchor attends; the median
block's whole time; and from the nanosecond timer the launch's span (first
block's start to last block's end), the blocks alive at the span's middle and
how late the median block starts. The stamps cost a few stores a block; the
main path's build has none of this.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what ends at each stamp after the first (stamp 0 is the block's start)
PHASES = ("q_request_list_kv_request", "q_k_wait", "scores", "push_strips", "strips_wait",
          "softmax_push", "p_wait_requests_v_wait", "split_p_and_first_p_v", "second_p_v",
          "further_exchanges", "output")
STAMPS = len(PHASES) + 1


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--anchors", type=int, default=64)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3_phase_clocks: needs the card")
    from evoke_tpu_torch.ops import _build
    from evoke_tpu_torch.ops import fusion_attention as fa

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    lib = ctypes.CDLL(str(_build.build("fusion_attention", ("-DFUSION_PHASE_CLOCKS",))))
    lib.fusion_attention_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.fusion_attention_phase_clocks.restype = ctypes.c_int
    fn = fa.bind(lib)
    fa._lib = lambda: fn          # the wrapper launches the measuring build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    t, h, dk, qn = 50, 8, 2048, args.anchors
    _, attend_np = smoke.partner_layout(qn)
    b = attend_np.shape[1]
    attend = torch.as_tensor(attend_np, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        plan = fa.launch_plan(t, dk, dtype)
        c = plan["cluster"]
        blocks = qn * c * h * plan["row_tiles"]
        stamps = torch.zeros(2, blocks, STAMPS, dtype=torch.int64, device=dev)
        if lib.fusion_attention_phase_clocks(stamps.data_ptr()) != 0:
            sys.exit("k3_phase_clocks: could not set the stamp buffer")
        xq = torch.randn(qn, t, h * dk, generator=g, device=dev).to(dtype)
        xk = torch.randn(b, t, h * dk, generator=g, device=dev).to(dtype)
        xv = torch.randn(b, t, h * dk, generator=g, device=dev).to(dtype)
        q = xq.reshape(qn, t, h, dk).transpose(1, 2)
        k = xk.reshape(b * t, h, dk).transpose(0, 1)
        v = xv.reshape(b * t, h, dk).transpose(0, 1)
        cycles, nanos, mhz = [], [], []
        for rep in range(args.reps + 1):
            flush.zero_()
            fa.masked_cross_view_attention(q, k, v, attend, t)
            torch.cuda.synchronize()
            if rep == 0:
                continue                      # warm-up
            cycles.append(stamps[0].clone())
            nanos.append(stamps[1].clone())
            if rep % 3 == 0:
                mhz.append(float(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                    capture_output=True, text=True).stdout.split()[0]))
        lib.fusion_attention_phase_clocks(None)
        # block (z, y, x) -> stamps[(z * H + y) * Q * C + x]; anchor = x // C
        cyc = torch.stack(cycles).double().reshape(len(cycles), h, qn, c, STAMPS)
        ns = torch.stack(nanos).double().reshape(len(nanos), -1, STAMPS)
        sm_mhz = sorted(mhz)[len(mhz) // 2]
        counts = torch.as_tensor(attend_np.sum(1), device=dev)
        out = {"dtype": str(dtype)[6:], "plan": plan, "sm_mhz": sm_mhz, "blocks": blocks}
        for n in sorted(set(counts.tolist())):
            sel = cyc[:, :, counts == n]                          # [reps, h, q_n, c, stamps]
            per = (sel[..., 1:] - sel[..., :-1]).reshape(-1, STAMPS - 1).median(0).values / sm_mhz
            out[f"attends_{n}"] = {
                "phase_us": {name: round(float(x), 3) for name, x in zip(PHASES, per)},
                "block_us": round(float(((sel[..., -1] - sel[..., 0]) / sm_mhz).median()), 3)}
        t0 = ns[..., 0].min(1, keepdim=True).values
        span = ns[..., -1].max(1, keepdim=True).values - t0
        mid = t0 + span / 2
        out["span_us"] = round(float(span.median() / 1e3), 3)
        out["blocks_alive_mid_span"] = float(((ns[..., 0] <= mid) & (ns[..., -1] >= mid))
                                             .sum(1).double().median())
        out["start_median_us"] = round(float((ns[..., 0] - t0).median(1).values.median() / 1e3), 3)
        print(json.dumps(out), flush=True)
        del q, k, v, xq, xk, xv


if __name__ == "__main__":
    main()
