"""Each cell of BENCHMARK.json, run as the driver runs it, on the card: a
short window, the result line's last line, ``correct`` true. Skips off the
card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    run = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 101), "--seconds", "5", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert run.returncode == 0, run.stderr[-4000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
