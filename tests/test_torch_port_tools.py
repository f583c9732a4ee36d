"""Port parity for the host pieces: ``tools/`` (section parser, report
statistics, factual serialization, benchmark builder), ``radgraph_serialize``,
``native/`` (the C++ WordLevel encoder and exact top-k) and the trace digest
(``core/profiling.py``), each against the JAX package's on the inputs of
tests/test_tools.py and tests/test_native.py; and a check that the port
imports nothing of JAX."""

import csv
import gzip
import json
import re
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from evoke_tpu.tools import benchmark_builder as jbb
from evoke_tpu.tools import factual_serialization as jfs
from evoke_tpu.tools import report_stats as jrs
from evoke_tpu.tools import section_parser as jsp
from evoke_tpu_torch.tools import benchmark_builder as tbb
from evoke_tpu_torch.tools import factual_serialization as tfs
from evoke_tpu_torch.tools import report_stats as trs
from evoke_tpu_torch.tools import section_parser as tsp

from test_tools import REPORT

ENTITY_TOKENS = ("the lungs are clear . no pleural effusion or pneumothorax . "
                 "possible mild edema .").split()
ENTITIES = [(1, 1, "ANAT-DP"), (3, 3, "OBS-DP"), (6, 7, "OBS-DA"), (9, 9, "OBS-DA"),
            (12, 13, "OBS-U")]


def both(name, *args, **kw):
    """(JAX result, port result) of the function ``name`` of the tools module."""
    mod, fn = name.split(".")
    j = {"sp": jsp, "rs": jrs, "fs": jfs, "bb": jbb}[mod]
    t = {"sp": tsp, "rs": trs, "fs": tfs, "bb": tbb}[mod]
    return getattr(j, fn)(*args, **kw), getattr(t, fn)(*args, **kw)


@pytest.mark.parametrize("text", [REPORT, "the heart is normal .", "",
                                  "FINDINGS: clear. IMPRESSION: none."])
def test_section_parser_matches_jax(text):
    j, t = both("sp.section_text", text)
    assert j == t
    for wanted in ("indication", "findings", "impression", "nonexistent"):
        j, t = both("sp.extract_section", text, wanted)
        assert j == t
    for name in ("Clinical History", "IMPRESSIONS", "Wet Read", "other thing"):
        assert jsp.normalize_section_name(name) == tsp.normalize_section_name(name)


@pytest.mark.parametrize("reports", [["one two three .", "a b . c d ."], [],
                                     ["The lungs are clear? Yes! Fine."]])
def test_report_stats_matches_jax(reports):
    j, t = both("rs.report_stats", reports)
    assert j == t


def test_factual_serialization_matches_jax(tmp_path):
    text = ("The lungs are clear. No pleural effusion or pneumothorax. "
            "Mild cardiomegaly is present.")
    j, t = both("fs.heuristic_core_findings", text)
    assert j == t and len(t) == 3
    j, t = both("fs.entities_to_core_findings", ENTITY_TOKENS, ENTITIES)
    assert j == t == ["lungs clear", "no pleural effusion pneumothorax", "maybe mild edema"]
    useless = "It is unremarkable . heart normal .".split()
    ents = [(0, 0, "OBS-DP"), (4, 4, "ANAT-DP"), (5, 5, "OBS-DP")]
    j, t = both("fs.entities_to_core_findings", useless, ents)
    assert j == t
    lobe = "left lower lobe opacity .".split()
    j, t = both("fs.resolve_overlapping_entities", [(0, 1, "ANAT-DP"), (0, 2, "ANAT-DP")], lobe)
    assert j == t
    line = json.dumps({"doc_key": "p1_s1", "sentences": [["no", "effusion", "."]],
                       "predicted_ner": [[[1, 1, "OBS-DA"]]]})
    j, t = both("fs.radgraph_jsonl_to_entities", [line])
    assert j == t
    ann = {"train": [{"id": "a", "subject_id": "p1", "study_id": "s1", "report": "raw"},
                     {"id": "b", "subject_id": "p2", "study_id": "s2",
                      "report": "heart,normal."}]}
    j, t = both("fs.merge_core_findings", ann, j)
    assert j == t

    def ann2():
        return {"train": [{"id": "a", "report": "the lungs are clear . no effusion .",
                           "raw_report": REPORT}]}

    assert jfs.serialize_annotation(ann2()) == tfs.serialize_annotation(ann2())
    ner = lambda texts: [[t.split()[0]] if t.split() else [] for t in texts]
    assert (jfs.serialize_annotation(ann2(), ner_fn=ner)
            == tfs.serialize_annotation(ann2(), ner_fn=ner))

    # prediction CSVs (named and trainer columns) and annotation files
    for col in ("pred_report", "pred_3"):
        src = tmp_path / f"pred_{col}.csv"
        with open(src, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["images_id", "ground_truth", col])
            w.writeheader()
            w.writerow({"images_id": "a", "ground_truth": "gt",
                        col: "the lungs are clear . no pleural effusion ."})
        jfs.serialize_predictions(str(src), str(tmp_path / "j.csv"))
        tfs.serialize_predictions(str(src), str(tmp_path / "t.csv"))
        assert (tmp_path / "j.csv").read_bytes() == (tmp_path / "t.csv").read_bytes()
    (tmp_path / "ann.json").write_text(json.dumps(ann2()))
    jfs.serialize_file(str(tmp_path / "ann.json"), str(tmp_path / "j.json"), use_radgraph=False)
    tfs.serialize_file(str(tmp_path / "ann.json"), str(tmp_path / "t.json"), use_radgraph=False)
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


def test_benchmark_builder_matches_jax(tmp_path):
    ann = {"train": [
        {"id": "s1", "report": "r1", "core_findings": ["x"],
         "image_path": ["a.jpg"], "multiview_image_path": ["b.jpg", "c.jpg"]},
        {"id": "s2", "report": "r2", "core_findings": ["y"],
         "image_path": ["d.jpg"], "multiview_image_path": []},
        {"id": "s3", "report": "r3", "core_findings": [],
         "image_path": ["e.jpg"], "multiview_image_path": ["f.jpg"]}]}
    for kw in (dict(view_positions={"a.jpg": "PA", "b.jpg": "LATERAL"}),
               dict(many_to_many=True), dict(require_core_findings=False, min_views=1)):
        j, t = both("bb.build_multiview_annotation", ann, **kw)
        assert j == t
    (tmp_path / "meta.csv").write_text("dicom_id,subject_id,study_id,ViewPosition\n"
                                       "d1,10,100,PA\nd2,10,100,LATERAL\nd3,11,101,\n")
    j, t = both("bb.load_mimic_view_positions", str(tmp_path / "meta.csv"))
    assert j == t
    item = {"id": "10_100", "image_path": ["files/p10/s100/d1.jpg"],
            "multiview_image_path": ["files/p10/s100/d2.jpg"]}
    assert both("bb.view_positions_for_item", item, j)[0] == tbb.view_positions_for_item(item, t)
    mimic = {"train": [
        {"id": "10_100", "report": "findings text", "core_findings": ["x"],
         "image_path": ["a/d1.jpg", "a/d2.jpg"], "indication_core_findings": "cough",
         "specific_knowledge": {"reports": ["r"]}},
        {"id": "10_101", "report": "single view", "core_findings": ["y"],
         "image_path": ["a/d3.jpg"]}], "val": [], "test": []}
    iu = {"train": [{"id": "CXR7_IM-2263-1001", "report": "iu findings", "core_findings": ["z"],
                     "image_path": ["CXR7_IM-2263/0.jpg", "CXR7_IM-2263/1.jpg"],
                     "indication_core_findings": "pain , ,, fever"}], "val": [], "test": []}
    iu_meta = {"CXR7": {"image_path": ["CXR7_IM-2263/0.jpg", "CXR7_IM-2263/1.jpg"],
                        "comparison": "none ."}}
    j = jbb.build_benchmark_merged(mimic, {"10_100_d1": "PA"}, iu, dict(iu_meta))
    t = tbb.build_benchmark_merged(mimic, {"10_100_d1": "PA"}, iu, dict(iu_meta))
    assert j == t and len(t["train"]) == 2
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    jbb.build_and_save(str(tmp_path / "ann.json"), str(tmp_path / "j.json"), many_to_many=True)
    tbb.build_and_save(str(tmp_path / "ann.json"), str(tmp_path / "t.json"), many_to_many=True)
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()


def test_tools_package_reexports():
    import evoke_tpu.tools as jt
    import evoke_tpu_torch.tools as tt

    names = ("section_text", "normalize_section_name", "build_multiview_annotation",
             "heuristic_core_findings", "serialize_annotation")
    assert all(hasattr(jt, n) and hasattr(tt, n) for n in names)
    assert tt.section_text is tsp.section_text


# ---------------------------------------------------------------- radgraph_serialize

class _StubRadGraph:
    """RadGraph with fixed annotations: report i gets ENTITIES from the
    (i % 2)-th on, those that fit in its tokens."""

    def __init__(self, model_path=None):
        self.model_path = model_path

    def __call__(self, reports):
        out = {}
        for i, r in enumerate(reports):
            ents = {str(n): {"tokens": "x", "label": lab, "start_ix": s, "end_ix": e,
                             "relations": []}
                    for n, (s, e, lab) in enumerate(ENTITIES[i % 2:])
                    if e < len(r.split())}
            out[str(i)] = {"text": r, "entities": ents}
        return out


def test_radgraph_serialize_matches_jax(monkeypatch, tmp_path):
    from evoke_tpu.evals import adapters as jad
    from evoke_tpu_torch.evals import adapters as tad

    monkeypatch.setitem(sys.modules, "radgraph", None)       # not installed
    (tmp_path / "one.json").write_text(json.dumps({"train": [{"id": "a", "report": "x ."}]}))
    for mod, fs in ((jad, jfs), (tad, tfs)):
        with pytest.raises(mod.MetricUnavailable):
            mod.radgraph_serialize(["no effusion ."])
        with pytest.raises(mod.MetricUnavailable):
            fs.serialize_file(str(tmp_path / "one.json"), str(tmp_path / "out.json"))
    monkeypatch.setitem(sys.modules, "radgraph", types.SimpleNamespace(RadGraph=_StubRadGraph))
    reports = [" ".join(ENTITY_TOKENS)] * 3
    for path in (None, "/models/radgraph"):
        j = jad.radgraph_serialize(reports, model_path=path)
        t = tad.radgraph_serialize(reports, model_path=path)
        assert j == t and t[0] == ["lungs clear", "no pleural effusion pneumothorax",
                                   "maybe mild edema"]
    ann = {"train": [{"id": "a", "report": " ".join(ENTITY_TOKENS), "raw_report": REPORT}]}
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    jfs.serialize_file(str(tmp_path / "ann.json"), str(tmp_path / "j.json"))
    tfs.serialize_file(str(tmp_path / "ann.json"), str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    assert (jfs.serialize_annotation(json.loads(json.dumps(ann)), ner_fn=jad.radgraph_serialize)
            == tfs.serialize_annotation(json.loads(json.dumps(ann)),
                                        ner_fn=tad.radgraph_serialize))


# ---------------------------------------------------------------- native

@pytest.fixture(scope="module")
def natives():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native library cannot be built")
    from evoke_tpu import native as jn
    from evoke_tpu_torch import native as tn

    assert jn.load_native() is not None and tn.load_native() is not None
    return jn, tn


def test_native_library_is_hashed_in_the_port_build_dir(natives):
    _, tn = natives
    path = Path(tn.build_native())
    assert path.parent == Path(tn.__file__).resolve().parent.parent / "_build"
    assert re.fullmatch(r"libevoke_native-[0-9a-f]{16}\.so", path.name) and path.exists()


def test_native_wordlevel_matches_jax(natives):
    from evoke_tpu.data.synthetic import corpus_for_tokenizer

    from evoke_tpu_torch.data.tokenizer import WordTokenizer

    jn, tn = natives
    tok = WordTokenizer.train(corpus_for_tokenizer())
    texts = ["the heart is NORMAL in size .", "no acute cardiopulmonary abnormality , really !",
             "unknownword123 and punctuation...here", "", "   whitespace   only -- sort. of",
             " ".join(["heart"] * 50)]
    j = jn.NativeWordLevel(tok.vocab, tok.unk_id).encode_padded_batch(texts, 16, tok.pad_id)
    t = tn.NativeWordLevel(tok.vocab, tok.unk_id).encode_padded_batch(texts, 16, tok.pad_id)
    np.testing.assert_array_equal(j, t)
    np.testing.assert_array_equal(t, np.stack([tok.encode_padded(x, 16) for x in texts]))


def test_native_topk_matches_jax(natives):
    jn, tn = natives
    rng = np.random.default_rng(0)
    for n, d, q, k, shared in ((300, 24, 12, 7, False), (40, 8, 4, 5, True)):
        db = rng.normal(size=(n, d)).astype(np.float32)
        queries = db[:q] if shared else rng.normal(size=(q, d)).astype(np.float32)
        db_codes = (np.arange(n) % (3 if shared else 50)).astype(np.int64)
        q_codes = (db_codes[:q] if shared else np.arange(q) + 1000).astype(np.int64)
        js, ji = jn.native_topk_ip(db, queries, db_codes, q_codes, k)
        ts, ti = tn.native_topk_ip(db, queries, db_codes, q_codes, k)
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(js, ts)


def test_native_without_a_compiler_raises(monkeypatch, tmp_path):
    """No g++: load_native gives None, the wrappers raise RuntimeError."""
    from evoke_tpu_torch import native as tn

    monkeypatch.setattr(tn, "_lib", None)
    monkeypatch.setattr(tn, "_tried", False)
    monkeypatch.setattr(tn, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tn.load_native() is None
    with pytest.raises(RuntimeError):
        tn.NativeWordLevel({"a": 0}, 0)
    with pytest.raises(RuntimeError):
        tn.native_topk_ip(np.zeros((2, 2), np.float32), np.zeros((1, 2), np.float32),
                          np.zeros(2, np.int64), np.ones(1, np.int64), 1)


# ---------------------------------------------------------------- the trace digest

def test_summarize_trace_matches_jax(tmp_path):
    from evoke_tpu.core import profiling as jp
    from evoke_tpu_torch.core import profiling as tp

    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 9,
               "args": {"name": "Steps"}},
              {"ph": "X", "name": "step 1", "pid": 1, "tid": 9, "dur": 1000}]
    for i in range(10):
        events += [{"ph": "X", "name": "lineage_kernel<bf16, 64, 3>", "pid": 1, "tid": 1,
                    "dur": 7 + i},
                   {"ph": "X", "name": "fusion.3", "pid": 1, "tid": 1, "dur": 3},
                   {"ph": "X", "name": "$python frame", "pid": 1, "tid": 2, "dur": 50}]
    events += [{"ph": "X", "name": "conv_general.12", "pid": 1, "tid": 1, "dur": 400},
               {"ph": "X", "name": "jit_encode", "pid": 1, "tid": 2, "dur": 900},
               {"ph": "i", "name": "marker", "pid": 1, "tid": 1}]
    sub = tmp_path / "plugins" / "profile" / "run"
    sub.mkdir(parents=True)
    with gzip.open(sub / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    j, t = jp.summarize_trace(str(tmp_path)), tp.summarize_trace(str(tmp_path))
    assert j == t
    assert [r["name"] for r in t["loop_ops"]] == ["lineage_kernel<bf16, 64, 3>", "fusion.3"]
    assert jp.format_summary(j) == tp.format_summary(t)
    with pytest.raises(FileNotFoundError):
        tp.summarize_trace(str(tmp_path / "empty"))


def test_capture_trace_of_a_cpu_loop_yields_loop_ops(tmp_path):
    from evoke_tpu_torch.core.profiling import capture_trace, format_summary, summarize_trace

    x = torch.randn(32, 32)

    def loop():
        y = x
        for _ in range(10):
            y = torch.tanh(y @ x)
        return y

    out = capture_trace(loop, str(tmp_path / "trace"))
    assert list(Path(out).glob("*.trace.json.gz"))
    report = summarize_trace(out)
    loop_ops = {r["name"]: r["count"] for r in report["loop_ops"]}
    assert loop_ops.get("aten::tanh") == 10 and loop_ops.get("aten::mm") == 10
    assert "aten::tanh" in format_summary(report)


# ---------------------------------------------------------------- the port stands alone

def test_port_imports_no_jax():
    """No module of evoke_tpu_torch (nor chip_smoke.py) imports jax, flax,
    optax or anything of evoke_tpu."""
    root = Path(__file__).resolve().parent.parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|evoke_tpu)(\.|\s|$)", re.M)
    files = sorted((root / "evoke_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 50
    bad = [str(f.relative_to(root)) for f in files if pat.search(f.read_text())]
    assert not bad, bad
    assert (root / "evoke_tpu_torch" / "native" / "evoke_native.cpp").exists()
