"""The last line's schema, and a run without the card."""

import json

import pytest

from pb import harness
from small import run_small


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    ctx, out = run_small("r2gen224.batch.lenmix", seconds=0.5, trace=trace)
    line = json.loads(json.dumps(harness.result_line(harness.load_benchmark(), ctx, out,
                                                      "NVIDIA H100 80GB HBM3", 1)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, check in line["checks"].items():
        assert set(check) == {"value", "limit"}, name
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and "memory_peak_bytes" in dev
    if trace:
        assert "busy_s" in dev and "window_s" in dev
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "reports_per_s" not in line["metrics"] and "decode_mfu" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"reports_per_s", "study_latency_p90_ms", "setup_s"}


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "r2gen224.batch.lenmix", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_unknown_cell_no_result(capsys):
    assert harness.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_per_layer_metric_names_its_cells():
    ctx, out = run_small("r2gen224.batch.lenmix", seconds=0.5, trace=True)
    bench = harness.load_benchmark()
    bench["per_layer"].append({"name": "decode_mfu_again", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "model step",
                               "moves": "reports_per_s"})
    with pytest.raises(KeyError, match="workloads"):
        harness.result_line(bench, ctx, out, "NVIDIA H100 80GB HBM3", 1)
