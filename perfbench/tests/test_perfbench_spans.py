"""The spans window (``pb/spans.py``): the split of the card's idle time by
what the server was doing, its metrics on the CPU, the recorder off in the
windows the other metrics read, and a program without the recorder."""

from types import SimpleNamespace

import pytest

from pb import harness, spans
from pb.trace import Trace
from small import run_small

SERVING = ["r2gen224.batch.lenmix", "cmn224.batch.full100", "r2gen224.continuous.lenmix"]
NEW = ["device_idle_share." + c for c in spans.CATEGORIES] + ["queue_wait_ms.batch",
                                                                "admission_wait_p90_ms"]
MAIN, OTHER = 1, 2


def span(name, start, end, thread=MAIN, **ids):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, thread=thread, ids=ids)


def test_split_by_overlap_innermost_span_and_other():
    # window 0-100; the card busy 10-20 and 60-70: idle 0-10, 20-60, 70-100
    trace = Trace([("k", 10, 20), ("k", 60, 70)], [], (0, 100))
    taken = [span("serve", 5, 95),
             span("serve.stage", 15, 30, batch=0),        # idle 20-30 of it
             span("generate.encode", 30, 45, batch=0),    # idle 30-45
             span("generate.decode", 45, 80, batch=0),    # idle 45-60, 70-80 ...
             span("decode.flag_read", 50, 55, batch=0),   # ... of which 50-55 a child's
             span("serve.loader_wait", 85, 90),
             span("loader.next", 0, 100, thread=OTHER),   # another thread: not counted
             span("study.queued", 0, 100)]                # no category: not counted
    got = spans.idle_split(trace, taken, MAIN)
    assert set(got) == set(spans.CATEGORIES)
    ns = {c: round(v * 1e9) for c, v in got.items()}
    # the straddling idle stretch 20-60 splits over stage, encode and decode
    # other: 0-5 (no span), 5-10, 80-85, 90-95 (serve's self time), 95-100
    assert ns == {"stage": 10, "encode": 15, "decode": 25, "loader": 5, "records": 0,
                  "other": 25}
    assert sum(ns.values()) == 100 - 20
    assert trace.busy_s == pytest.approx(20e-9)


def test_split_of_a_window_with_no_span_is_all_other():
    trace = Trace([("k", 40, 50)], [], (0, 100))
    got = spans.idle_split(trace, [], MAIN)
    assert round(got["other"] * 1e9) == 90 and sum(got.values()) == pytest.approx(90e-9)


def enabled_at_each_serve(monkeypatch):
    from evoke_tpu_torch.core.profiling import spans as recorder
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.serve import ReportServer

    seen = []
    for cls in (ReportServer, ContinuousServer):
        def wrapped(self, *a, _serve=cls.serve, **kw):
            seen.append(recorder.enabled)
            return _serve(self, *a, **kw)
        monkeypatch.setattr(cls, "serve", wrapped)
    return seen


@pytest.mark.parametrize("cell", SERVING)
def test_new_metrics_read_on_the_cpu(cell, monkeypatch, capsys):
    from evoke_tpu_torch.core.profiling import spans as recorder

    seen = enabled_at_each_serve(monkeypatch)
    ctx, out = run_small(cell, seconds=0.5, trace=True)
    # warm, warm-up loop, measured window, traced window: the recorder off,
    # and nothing kept
    assert seen and not any(seen) and recorder.drain() == []
    bench = harness.load_benchmark()
    line = harness.result_line(bench, ctx, out, "NVIDIA H100 80GB HBM3", 1)
    assert seen[-1] is True and not any(seen[:-1])      # the spans window alone
    assert not recorder.enabled and recorder.drain() == []
    listed = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert set(NEW) & listed <= set(line["metrics"])
    assert {"queue_wait_ms.batch" in listed, "admission_wait_p90_ms" in listed} == {
        True, False}
    # off the card nothing runs on a device: the whole window is idle
    total = sum(line["metrics"]["device_idle_share." + c]["value"] for c in spans.CATEGORIES)
    assert total == pytest.approx(100.0, abs=1e-6)
    assert line["metrics"]["device_idle_share.other"]["value"] < 50.0
    for name in ("queue_wait_ms.batch", "admission_wait_p90_ms"):
        if name in listed:
            assert line["metrics"][name]["value"] > 0
    assert "the recorder off / on" in capsys.readouterr().err


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from evoke_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "spans")
    ctx, out = run_small("r2gen224.batch.lenmix", seconds=0.5, trace=True)
    line = harness.result_line(harness.load_benchmark(), ctx, out, "NVIDIA H100 80GB HBM3", 1)
    assert not set(NEW) & set(line["metrics"])
    assert "device_idle_share.serve" in line["metrics"]
