"""Readings for a serving cell's ``correct`` limit, several seeds in one
process: each seed's run as the benchmark makes it (set-up, a window of
``--seconds``), then the checks that the run holds the program to, and the
same checks with the float8 control put in the program's place, both
against the float32 reference. Prints one JSON line per seed, then each
number's lower reading (the program's largest) and upper reading (the
control's smallest), and how many control runs came out correct.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (HERE, os.path.dirname(HERE)) if p not in sys.path]
os.environ["USE_FLAX"] = "0"


def main():
    import argparse

    import torch

    from pb import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    readings = {"program": {}, "control": {}}
    control_correct = 0
    for seed in [int(x) for x in args.seeds.split(",")]:
        ctx = harness.make_context(args.workload, seed, args.seconds, False, dev,
                                   time.perf_counter())
        ctx.extra["control"] = True
        out = harness.run_cell(ctx)
        got = {"program": out.checks, "control": ctx.extra["control_checks"]}
        for kind, checks in got.items():
            for name, value, _, _ in checks:
                readings[kind].setdefault(name, []).append(value)
        control_correct += all(ok for _, _, _, ok in got["control"])
        print(json.dumps({"seed": seed, "program_correct": out.correct,
                          "control_correct": all(ok for _, _, _, ok in got["control"]),
                          **{k: [list(c) for c in v] for k, v in got.items()},
                          "end_to_end": out.end_to_end}), flush=True)
        torch.cuda.empty_cache()
    gap = "served_gap"
    print(json.dumps({"workload": args.workload, "readings": readings,
                      "lower": max(readings["program"][gap]),
                      "upper": min(readings["control"][gap]),
                      "control_runs_correct": control_correct}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
