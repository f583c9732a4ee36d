"""K2's bfloat16 wrapper timed three ways at the serving shapes, for the port
found under ``--root`` (default: this checkout), so that two trees compare
within one call on one card:

    python3 scripts/k2_wrapper_time.py [--root DIR] [--calls 1000]

Per shape (N 192 and 96, D 512, V 30001, k 3, suppress_ids (4,)), with
chip_smoke.py's timers: ``host_us``, the host time of one wrapper call
(host clock, median of ``--calls``, the device synchronized between calls);
``ms``, the call's CUDA-event time after a 64 MB L2-evicting memset, which
includes host time that outlasts the memset; ``device_only_ms``, the same
with the device spinning ~0.1 ms first, so only the device's work is timed.
Prints one JSON line.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout whose evoke_tpu_torch is timed")
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("k2_wrapper_time: needs the card")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int8, device=dev)
    d, v, out = 512, 30001, {"root": os.path.abspath(args.root)}
    w = (torch.randn(v, d, generator=g, device=dev) / math.sqrt(d)).bfloat16()
    b = (torch.randn(v, generator=g, device=dev) * 0.1).bfloat16()
    for n in (192, 96):
        h = torch.randn(n, d, generator=g, device=dev).bfloat16()

        def call():
            fused_logit_topk(h, w, b, 3, (4,))

        out[f"N{n}"] = dict(host_us=smoke.host_us(call, args.calls),
                            ms=smoke.time_ms(call, flush),
                            device_only_ms=smoke.time_ms(call, flush, device_only=True))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
