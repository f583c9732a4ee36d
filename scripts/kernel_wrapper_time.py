"""One kernel's wrapper timed three ways at the serving shapes, for the port
found under ``--root`` (default: this checkout), so that two trees compare
within one call on one card (run parent, change, change, parent):

    python3 scripts/kernel_wrapper_time.py --kernel k1|k2 [--root DIR] [--calls 1000]

k1: lineage attention, 64 samples x beam 3, d 512, 8 heads, bf16, batch mode
at pos = L - 1, uniformly random lineages, L 100 and L 50. k2: the fused
logit + top-k tail, bf16, N 192 and 96, D 512, V 30001, k 3, suppress_ids
(4,). Per shape, with chip_smoke.py's timers: ``host_us``, the host time of
one wrapper call (host clock, median of ``--calls``, the device synchronized
between calls); ``ms``, the call's CUDA-event time after a 64 MB L2-evicting
memset, which includes host time that outlasts the memset;
``device_only_ms``, the same with the device spinning ~0.1 ms first, so only
the device's work is timed. Prints one JSON line.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k1_calls(torch, dev, g):
    from evoke_tpu_torch.ops.lineage_attention import lineage_attention

    b, kbeam, d, heads = 64, 3, 512, 8
    for lmax in (100, 50):
        q = torch.randn(b * kbeam, d, generator=g, device=dev).bfloat16()
        ck = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
        cv = torch.randn(b * kbeam, lmax, d, generator=g, device=dev).bfloat16()
        anc = torch.randint(0, kbeam, (b, kbeam, lmax), generator=g, device=dev,
                            dtype=torch.int32)
        yield f"L{lmax}", lambda a=(q, ck, cv, anc, lmax - 1, heads): lineage_attention(*a)


def k2_calls(torch, dev, g):
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk

    d, v = 512, 30001
    w = (torch.randn(v, d, generator=g, device=dev) / math.sqrt(d)).bfloat16()
    b = (torch.randn(v, generator=g, device=dev) * 0.1).bfloat16()
    for n in (192, 96):
        h = torch.randn(n, d, generator=g, device=dev).bfloat16()
        yield f"N{n}", lambda h=h: fused_logit_topk(h, w, b, 3, (4,))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=("k1", "k2"), required=True)
    ap.add_argument("--root", default=REPO, help="checkout whose evoke_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_wrapper_time: needs the card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    out = {"kernel": args.kernel, "root": os.path.abspath(args.root)}
    for shape, call in {"k1": k1_calls, "k2": k2_calls}[args.kernel](torch, dev, g):
        out[shape] = dict(host_us=smoke.host_us(call, args.calls),
                          ms=smoke.time_ms(call, flush),
                          device_only_ms=smoke.time_ms(call, flush, device_only=True))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
