"""The span recorder (core/profiling.spans) and the spans the two
serving engines open at their layer boundaries, on the CPU at toy size."""

import gzip
import json
import threading
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.core.profiling import (SPANS_PROCESS, SpanRecorder, capture_trace,
                                            spans, summarize_trace)
from evoke_tpu_torch.data.batching import Prefetcher
from evoke_tpu_torch.decode.continuous import ContinuousServer
from evoke_tpu_torch.decode.forcing import synthetic_tokenizer
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.params import init_params_
from evoke_tpu_torch.serve import ReportServer

from _torch_port_util import TINY

torch.set_num_threads(1)
VOCAB = 50
WIDTH = 3

BOTH = {"serve", "serve.loader_wait", "serve.stage", "serve.records", "loader.next"}
BATCH = BOTH | {"generate.encode", "generate.decode", "decode.phase", "decode.flag_read",
                "serve.read"}
CONTINUOUS = BOTH | {"continuous.encode", "continuous.fuse", "continuous.load_pack",
                     "continuous.dispatch", "continuous.wait", "continuous.harvest",
                     "study.queued", "study.decoding"}


@pytest.fixture
def recorder():
    spans.drain()
    spans.enable()
    yield spans
    spans.disable()
    spans.drain()


@pytest.fixture(scope="module")
def model():
    m = FinetuneModel(vocab_size=VOCAB, **TINY)
    return init_params_(m, 0).eval()


def batches(n, width=WIDTH):
    """``n`` loader batches of ``width`` studies, each with one aux view."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        pids = np.concatenate([np.arange(width), np.arange(width)]).astype(np.int32)
        out.append({"images": rng.normal(size=(2 * width, 32, 32, 3)).astype(np.float32),
                    "ids": np.ones((width, 16), np.int32),
                    "mask": np.ones((width, 16), np.int32), "pids": pids,
                    "valid": np.ones(2 * width, bool),
                    "inc_ids": rng.integers(5, VOCAB - 3, (width, 16)).astype(np.int32),
                    "inc_mask": np.ones((width, 16), np.int32),
                    "_image_ids": [f"b{k}s{j}" for j in range(width)]})
    return out


def test_off_keeps_no_span_and_the_totals_count():
    rec = SpanRecorder()
    for _ in range(2):
        with rec.span("site", batch=1):
            time.sleep(0.001)
    with rec.tag(batch=2):
        rec.record("study.queued", 1.0, 2.0, ticket=0)
    assert rec.drain() == [] and rec._spans == []
    assert rec.totals()["site"][1] == 2 and rec.seconds("site") >= 0.002
    assert "study.queued" not in rec.totals()


def test_nesting_parents_and_inherited_ids():
    rec = SpanRecorder()
    rec.enable()
    with rec.span("outer", batch=7) as outer:
        with rec.tag(ticket=3):
            with rec.span("inner", phase=0):
                pass
        with rec.span("sibling"):
            pass
    with rec.span("root"):
        pass
    got = {s.name: s for s in rec.drain()}
    assert set(got) == {"outer", "inner", "sibling", "root"}
    o, i, s, r = got["outer"], got["inner"], got["sibling"], got["root"]
    assert o.parent == 0 and r.parent == 0 and i.parent == s.parent == o.id
    assert len({o.id, i.id, s.id, r.id}) == 4
    assert i.ids == {"batch": 7, "ticket": 3, "phase": 0} and s.ids == {"batch": 7}
    assert o.start_ns <= i.start_ns <= i.end_ns <= s.start_ns <= s.end_ns <= o.end_ns
    assert o.end_ns <= r.start_ns
    assert o.end_ns - o.start_ns == pytest.approx(
        time.perf_counter_ns() - outer.t0, abs=10 ** 9)     # nanoseconds, not seconds
    assert rec.drain() == []


def test_prefetcher_spans_carry_their_own_thread(recorder):
    assert [b for b in Prefetcher(range(3), depth=1)] == [0, 1, 2]
    with recorder.span("main"):
        pass
    taken = recorder.drain()
    loader = [s for s in taken if s.name == "loader.next"]
    main = threading.get_ident()
    assert sorted(s.ids["batch"] for s in loader) == [0, 1, 2, 3]   # 3: the end
    assert {s.thread for s in loader} != {main} and len({s.thread for s in loader}) == 1
    assert all(s.parent == 0 for s in loader)
    assert [s.thread for s in taken if s.name == "main"] == [main]


def test_spans_share_the_profilers_clock(recorder):
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("around"):
            with record_function("ranged"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
    (s,) = [s for s in recorder.drain() if s.name == "around"]
    (e,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "ranged"]
    start, end = e.start_ns(), e.start_ns() + e.duration_ns()
    assert s.start_ns <= start + 10 ** 6 and abs(start - s.start_ns) < 10 ** 6
    assert s.end_ns >= end - 10 ** 6 and abs(s.end_ns - end) < 10 ** 6


def by_batch(taken):
    out = defaultdict(set)
    for s in taken:
        if "batch" in s.ids:
            out[s.ids["batch"]].add(s.name)
    return out


def test_report_server_spans(model, recorder):
    srv = ReportServer(model, synthetic_tokenizer(VOCAB), DecodeConfig(beam_size=3), 16,
                       device="cpu")
    records = srv.serve(batches(2), with_indication=True)
    taken = recorder.drain()
    assert len(records) == 2 * WIDTH
    assert {s.name for s in taken} == BATCH
    per = by_batch(taken)
    assert sorted(per) == [0, 1, 2]      # loader.next of batch 2 meets the loader's end
    for b in (0, 1):
        assert per[b] == BATCH - {"serve"}, b
    ids = {s.id: s for s in taken}
    for s in taken:
        if s.name in ("decode.phase", "decode.flag_read"):
            assert ids[s.parent].name == "generate.decode"
        if s.name in ("generate.encode", "generate.decode", "serve.stage", "serve.read"):
            assert ids[s.parent].name == "serve"
    # the last batch's phases and flag reads are the loop's own counts
    (loop,) = [loop for loop, _ in srv._gen[True].loops.values()]
    last = [s for s in taken if s.ids.get("batch") == 1]
    assert sum(s.ids["steps"] for s in last if s.name == "decode.phase") == loop.steps_run > 0
    assert sum(s.name == "decode.flag_read" for s in last) == loop.flag_reads > 0
    assert srv.stats["batches"] == 2 and srv.stats["batch_latency_p50_s"] > 0


def test_continuous_server_spans(model, recorder):
    srv = ContinuousServer(model, synthetic_tokenizer(VOCAB), max_seq_len=16, slots=2,
                           beam_size=3, seg_steps=4, pack_batches=2, device="cpu")
    records, stats = srv.serve(batches(3))
    taken = recorder.drain()
    assert len(records) == 3 * WIDTH
    assert {s.name for s in taken} == CONTINUOUS
    per = by_batch(taken)
    for b in (0, 1, 2):
        assert per[b] == {"loader.next", "serve.loader_wait", "serve.stage",
                          "continuous.encode"}, b
    tickets = Counter((s.name, s.ids["ticket"]) for s in taken if s.name.startswith("study."))
    assert set(tickets.values()) == {1}
    assert {t for _, t in tickets} == set(range(3 * WIDTH))
    assert len(tickets) == 2 * 3 * WIDTH
    queued = {s.ids["ticket"]: s for s in taken if s.name == "study.queued"}
    for s in taken:
        if s.name == "study.decoding":
            assert queued[s.ids["ticket"]].end_ns == s.start_ns <= s.end_ns
    dispatches = [s.ids["dispatch"] for s in taken if s.name == "continuous.dispatch"]
    assert dispatches == list(range(len(dispatches)))
    for key, name in (("encode_s", "continuous.encode"), ("dispatch_s", "continuous.dispatch"),
                      ("wait_s", "continuous.wait")):
        total = sum(s.end_ns - s.start_ns for s in taken if s.name == name) / 1e9
        assert stats[key] == pytest.approx(total, abs=1e-6), key
    assert stats["encode_s"] > 0


def test_continuous_stats_read_the_totals_with_the_recorder_off(model):
    srv = ContinuousServer(model, synthetic_tokenizer(VOCAB), max_seq_len=16, slots=2,
                           beam_size=3, seg_steps=4, pack_batches=1, device="cpu")
    before = spans.totals()
    _, stats = srv.serve(batches(2))
    after = spans.totals()
    assert spans.drain() == []
    for key, name in (("encode_s", "continuous.encode"), ("dispatch_s", "continuous.dispatch"),
                      ("wait_s", "continuous.wait")):
        assert stats[key] == pytest.approx(after[name][0] - before.get(name, (0, 0))[0],
                                           abs=1e-9)
    assert after["continuous.encode"][1] - before.get("continuous.encode", (0, 0))[1] == 2


def test_capture_trace_writes_the_spans_beside_the_operations(tmp_path, recorder):
    x = torch.randn(32, 32)

    def loop():
        y = x
        for i in range(10):
            with spans.span("step", batch=i):
                y = torch.tanh(y @ x)
        return y

    out = capture_trace(loop, str(tmp_path / "trace"))
    (path,) = Path(out).glob("*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    (pid,) = [e["pid"] for e in events if e.get("ph") == "M"
              and e.get("name") == "process_name" and e["args"]["name"] == SPANS_PROCESS]
    steps = [e for e in events if e.get("pid") == pid and e.get("ph") == "X"]
    assert [e["args"]["batch"] for e in steps] == list(range(10))
    assert all(e["name"] == "step" and e["dur"] > 0 for e in steps)
    mm = [e for e in events if e.get("ph") == "X" and e.get("name") == "aten::mm"]
    assert mm and steps[0]["ts"] <= mm[0]["ts"] <= steps[0]["ts"] + steps[0]["dur"]
    report = summarize_trace(out)
    names = {r["name"] for r in report["loop_ops"] + report["oneshot_ops"]}
    assert "step" not in names and "aten::mm" in names
    assert recorder.drain() == []


def test_staged_batches_number_each_batch_and_check_its_partners(recorder):
    from evoke_tpu_torch.serve import staged_batches

    got = list(staged_batches(batches(3), torch.device("cpu"), depth=1, max_partners=1))
    assert [host["_batch"] for _, host in got] == [0, 1, 2]
    assert all(host["_valid"].all() and host["_t_stage"] > 0 for _, host in got)
    assert all(dev["images"].shape[0] == 2 * WIDTH for dev, _ in got)
    staged = [s for s in recorder.drain() if s.name == "serve.stage"]
    assert [s.ids["batch"] for s in staged] == [0, 1, 2]
    with pytest.raises(ValueError, match="partner views"):
        list(staged_batches(batches(1), torch.device("cpu"), max_partners=0))
