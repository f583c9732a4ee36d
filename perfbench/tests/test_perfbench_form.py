"""BENCHMARK.json keeps the form the benchmark's contract gives it, and every
cell file agrees with its entry there."""

import json
import os
import re

from conftest import BENCH, ROOT

BENCHMARK = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not re.search(r"[\n\t]", text)


def test_keys_and_names():
    b = BENCHMARK
    assert set(b) == KEYS["top"]
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
    for kind in ("end_to_end", "per_layer"):
        for m in b[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert line(m["layer"]) and m["moves"] in {e["name"] for e in b["end_to_end"]}
    for e in b["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25
    names = ([c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
             + [m["name"] for k in ("end_to_end", "per_layer") for m in b[k]])
    assert len(names) == len(set(names))


def test_each_pair_of_config_and_traffic_names_one_cell():
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def test_cell_files_agree_with_their_entries():
    configs = {c["name"] for c in BENCHMARK["configs"]}
    for w in BENCHMARK["workloads"]:
        cell = json.load(open(os.path.join(BENCH, "cells", w["name"] + ".json")))
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"]), w["name"]
        assert w["config"] in configs
        assert os.path.isfile(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    used = {w["config"] for w in BENCHMARK["workloads"]}
    assert used == configs


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCHMARK["workloads"]:
        e2e = [m["name"] for m in BENCHMARK["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        mine = [m for m in BENCHMARK["per_layer"] if w["name"] in m["workloads"]]
        assert mine and all(m["moves"] in e2e for m in mine), w["name"]
