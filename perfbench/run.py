"""The benchmark of evoke_tpu_torch on an NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints one JSON line (the last line of
standard output) with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, the traced run's ``breakdown`` and ``checks``; exits non-zero
without a result when the card is missing or the run fails.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"       # a library that would load JAX by itself does not
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

from pb.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
