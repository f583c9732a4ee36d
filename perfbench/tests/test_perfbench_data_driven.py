"""A cell, a configuration, a traffic mix and a per-layer metric are files of
their own, found by name: a copy of the benchmark gains one of each by adding
files alone, and its run reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT
from small import small


def test_new_cell_config_mix_and_metric_as_files(tmp_path):
    copy = tmp_path / "perfbench"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("pb/harness.py", "pb/serving.py", "engines/batch_serve.py")}
    cell, cfg, traffic = small("r2gen224.batch.lenmix")
    cfg["name"] = "dummy-config"
    (copy / "configs" / "dummy-config.json").write_text(json.dumps(cfg))
    traffic["report_words"] = {"median": 5, "sigma": 0.3, "clip": [3, 9]}
    (copy / "traffic" / "dummy-mix.json").write_text(json.dumps(traffic))
    cell.update(config="dummy-config", traffic="dummy-mix")
    (copy / "cells" / "dummy.cell.json").write_text(json.dumps(cell))
    (copy / "metrics" / "dummy_reports.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.studies))\n")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                               "traffic": "dummy-mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_reports", "unit": "reports", "better": "higher",
                               "source": "program_counter", "layer": "server",
                               "moves": "reports_per_s", "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time, torch; sys.path[:0] = [%r, %r]\n"
        "from pb import harness\n"
        "ctx = harness.make_context('dummy.cell', 5, 0.5, True, torch.device('cpu'),"
        " time.perf_counter())\n"
        "out = harness.run_cell(ctx)\n"
        "line = harness.result_line(harness.load_benchmark(), ctx, out, 'cpu', 1)\n"
        "print(json.dumps(line))\n" % (str(copy), ROOT))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["metrics"]["dummy_reports"]["value"] > 0
    for p, content in before.items():
        assert open(copy / p, "rb").read() == content
