"""Port parity: knowledge retrieval (retrieval/topk.py and ``cli retrieve``)
against the JAX package on the same numpy inputs, on the CPU, and the stage
1 -> retrieval -> stage 2 chain of the port's CLI.

Tolerances: top-k ids equal; scores 1e-6 (rtol and atol: float32 products in
another summation order; the tie cases use integer-valued embeddings, whose
products are exact). ``stable_code``, the annotation JSON (byte for byte),
``retrieval_quality`` and the retrieval grids (pixel for pixel) equal."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from evoke_tpu import cli as jcli
from evoke_tpu.data import synthetic as jsynthetic
from evoke_tpu.retrieval import topk as jtopk
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.params import flax_to_state_dict
from evoke_tpu_torch.retrieval import topk as ttopk

torch.set_num_threads(2)


def test_stable_code_equals_jax():
    keys = ["", "s0", "p10000032_s50414267", "files/p10/p10000032/s5/img.jpg", "é"]
    assert [ttopk.stable_code(k) for k in keys] == [jtopk.stable_code(k) for k in keys]
    assert all(0 <= ttopk.stable_code(k) < 2 ** 63 for k in keys)


def _index_case(case):
    """(db, db study codes, queries, query codes, k, chunk, query chunk).
    Integer-valued embeddings in [-2, 2] plant exact ties; ``ties`` also
    repeats rows across chunks; ``under_filled``: query 0 shares its study
    with all but 2 rows (k 4); ``k_over_n``: 3 rows, k 10; ``short_chunk``:
    23 rows in chunks of 10 (the last 3 < k 5)."""
    rng = np.random.default_rng({"ties": 0, "under_filled": 1, "k_over_n": 2,
                                 "short_chunk": 3}[case])
    n, d, q, k, chunk = {"ties": (40, 6, 9, 6, 7), "under_filled": (12, 6, 4, 4, 5),
                         "k_over_n": (3, 6, 4, 10, 2), "short_chunk": (23, 6, 7, 5, 10)}[case]
    db = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    if case == "ties":
        db[[11, 25, 33]] = db[4]
    codes = (np.arange(n) // 2).astype(np.int64)
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    qcodes = np.arange(q, dtype=np.int64) + 1000
    qcodes[1] = codes[-1]                      # one query shares a study with db rows
    if case == "under_filled":
        codes[:] = 7
        codes[[3, 8]] = 8
        qcodes[0] = 7
    return db, codes, queries, qcodes, k, chunk, 3


@pytest.mark.parametrize("case", ["ties", "under_filled", "k_over_n", "short_chunk"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_topk_index_equals_jax(case, dtype):
    db, codes, queries, qcodes, k, chunk, qchunk = _index_case(case)
    ids = [f"id{i}" for i in range(len(db))]
    js, ji = jtopk.TopKIndex(db.astype(dtype).astype(np.float32), codes, ids,
                             chunk_size=chunk).search(queries, qcodes, k, query_chunk=qchunk)
    index = ttopk.TopKIndex(db.astype(dtype), codes, ids, chunk_size=chunk, device="cpu")
    ts, ti = index.search(queries.astype(dtype), qcodes, k, query_chunk=qchunk)
    assert ts.dtype == np.float32 and ti.shape == ji.shape == (len(queries), min(k, len(db)))
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), rtol=1e-6, atol=1e-6)
    same = codes[ti] == qcodes[:, None]
    assert (ts[same] == ttopk.NEG_INF).all()   # a same-study row only fills an empty slot
    if case == "under_filled":
        assert list(ti[0, 2:]) == [0, 0] and (ts[0, 2:] == ttopk.NEG_INF).all()
    if case == "ties":
        # equal scores keep the lower database index, as lax.top_k does
        for row_s, row_i in zip(ts, ti):
            for a in range(k - 1):
                assert row_s[a] > row_s[a + 1] or row_i[a] < row_i[a + 1]


def test_topk_index_refuses_mismatched_sizes():
    with pytest.raises(ValueError, match="ids"):
        ttopk.TopKIndex(np.zeros((3, 2), np.float32), np.zeros(3, np.int64), ["a", "b"],
                        device="cpu")


def test_encode_corpus_equals_jax():
    rng = np.random.default_rng(4)
    batches = []
    for i in range(3):
        b = {"valid": np.array([True, i != 1, True, False]),
             "_image_ids": [f"b{i}_{j}" for j in range(3)]}
        if i == 2:
            b["_study_keys"] = [f"p{j}_s{i}" for j in range(3)]
        b["out"] = rng.normal(size=(3, 2, 5)).astype(np.float32)
        batches.append(b)
    for flatten in (True, False):
        je, jc, jids = jtopk.encode_corpus(lambda b: b["out"], batches, flatten)
        te, tc, tids = ttopk.encode_corpus(lambda b: torch.as_tensor(b["out"]), batches, flatten)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tc, jc)
        assert tids == jids and len(tids) == 8


def _ann():
    return {
        "train": [{"id": "t1", "report": "the heart is normal .", "core_findings": ["heart"],
                   "image_path": ["t1.png"]},
                  {"id": "t2", "report": "no effusion seen .", "core_findings": ["effusion"],
                   "image_path": ["t2.png"]},
                  {"id": "t3", "report": "", "image_path": ["t3.png"]}],
        "val": [{"id": "v1", "report": "the heart is normal today .", "image_path": ["v1.png"]},
                {"id": "v2", "report": "lungs are clear .", "image_path": ["missing.png"]}],
        "test": [],
    }


def test_annotation_and_quality_equal_jax(tmp_path):
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(_ann()))
    results = {"train": {"t1": ["t2", "t3"], "t2": ["t1", "t3"]},
               "val": {"v1": ["t1", "t2", "zz"], "v2": ["t2", "t1"]}, "test": {}}
    outs = []
    for side, mod in (("jax", jtopk), ("torch", ttopk)):
        out = mod.build_knowledge_annotation(str(ann_path), str(tmp_path / f"{side}.json"),
                                             ["train", "val", "test"], results, topk=2)
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]
    aug = json.loads(outs[1])
    assert aug["val"][0]["specific_knowledge"] == {
        "sk_ids": ["t1", "t2"], "reports": ["the heart is normal .", "no effusion seen ."],
        "sk_keywords": [["heart"], ["effusion"]]}
    id_to_item = {it["id"]: it for it in aug["train"]}
    for split in ("train", "val", "test"):
        for topk in (1, 2, 5):
            assert (ttopk.retrieval_quality(aug, split, id_to_item, topk)
                    == jtopk.retrieval_quality(aug, split, id_to_item, topk))
    assert ttopk.retrieval_quality(aug, "val", id_to_item, 2)["n_scored"] == 2.0


def test_plot_topk_images_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    for name in ("t1", "t2", "t3", "v1"):
        Image.fromarray(rng.integers(0, 256, size=(40, 30, 3), dtype=np.uint8)).save(
            tmp_path / f"{name}.png")
    ann = _ann()
    results = {"train": {"t1": ["t2", "t3"], "t2": ["t1"]}, "val": {"v1": ["t1", "t2"],
                                                                    "v2": ["t2"]}}
    id_to_item = {it["id"]: it for it in ann["train"]}
    for split in ("train", "val"):
        ttopk.attach_specific_knowledge(ann, split, results[split], id_to_item, 2)
    for split in ("train", "val"):
        jw = jtopk.plot_topk_images(ann, split, id_to_item, str(tmp_path), str(tmp_path / "j"),
                                    topk=2, n_studies=5, seed=3)
        tw = ttopk.plot_topk_images(ann, split, id_to_item, str(tmp_path), str(tmp_path / "t"),
                                    topk=2, n_studies=5, seed=3)
        assert [os.path.basename(p) for p in tw] == [os.path.basename(p) for p in jw]
        assert len(tw) == 2
        for a, b in zip(tw, jw):
            assert np.array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))


# ---- the retrieve CLI ----

CLI_TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.image_size", "32",
    "--data.max_seq_len", "16", "--data.batch_size", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
    # one image worker: the JAX batcher draws augmentation seeds inside its
    # worker threads, so only one worker makes its train pass reproducible
    "--data.num_workers", "1",
]


@pytest.fixture(scope="module")
def retrieve_runs(tmp_path_factory):
    """The JAX CLI's ``retrieve`` and the port's ``retrieve --device cpu``
    with the same stage-1 weights (the JAX CLI's own seeded init, converted
    to a state dict file), same-corpus and cross-corpus."""
    root = str(tmp_path_factory.mktemp("retrieve"))
    ann = jsynthetic.write_synthetic_dataset(root, n_train=7, n_val=2, n_test=3,
                                             image_size=32, seed=2)
    db_root = os.path.join(root, "db")
    db_ann = jsynthetic.write_synthetic_dataset(db_root, n_train=5, n_val=1, n_test=1,
                                                image_size=32, seed=9)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results"),
              "--data.retrieve_topk", "3"] + CLI_TINY
    cross = ["--data.retrieve_db_ann_path", db_ann, "--data.retrieve_db_image_dir", db_root]
    out = ann.replace(".json", "_best_reports_keywords_3.json")
    init, states = jcli.init_pretrain_state, []
    files = {}
    try:
        jcli.init_pretrain_state = lambda *a: states.append(init(*a)) or states[-1]
        for mode, extra in (("same", []), ("cross", cross)):
            assert jcli.main(["retrieve"] + common + extra) == 0
            files[("jax", mode)] = open(out, "rb").read()
    finally:
        jcli.init_pretrain_state = init
    state = states[0][0]
    weights = os.path.join(root, "stage1.pt")
    tcheckpoint.save_state_dict(flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}), weights)
    for mode, extra in (("same", []), ("cross", cross)):
        os.remove(out)
        assert tcli.main(["retrieve", "--device", "cpu", "--trainer.load", weights]
                         + common + extra) == 0
        files[("torch", mode)] = open(out, "rb").read()
    return dict(files=files, root=root, ann=ann, common=common)


@pytest.mark.parametrize("mode", ["same", "cross"])
def test_retrieve_cli_writes_jax_annotation(retrieve_runs, mode):
    files = retrieve_runs["files"]
    assert files[("torch", mode)] == files[("jax", mode)]
    aug = json.loads(files[("torch", mode)])
    ids = {it["id"] for it in aug["train"]}
    for split in ("train", "val", "test"):
        for item in aug[split]:
            sk = item["specific_knowledge"]
            assert len(sk["sk_ids"]) == 3
            if mode == "same":
                assert set(sk["sk_ids"]) <= ids and len(sk["reports"]) == 3
    assert all(it["id"] not in it["specific_knowledge"]["sk_ids"] for it in aug["train"]
               if mode == "same")


def test_retrieve_cli_plots_and_refusals(retrieve_runs, capsys, monkeypatch):
    common = retrieve_runs["common"]
    assert tcli.main(["retrieve", "--device", "cpu", "--data.retrieve_plot", "2",
                      "--trainer.version", "plots"] + common) == 0
    printed = capsys.readouterr().out
    plots = os.path.join(retrieve_runs["root"], "results", "mimic_cxr", "pretrain", "plots",
                         "sk_analysis")
    assert "wrote 2 train retrieval grids" in printed and len(os.listdir(plots)) == 2 + 2 + 2
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcli.main(["retrieve", "--device", "cpu", "--data.retrieve_tpok", "3"] + common)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["retrieve"] + common)


def test_pretrain_retrieve_finetune_chain(tmp_path):
    """Stage 1 -> knowledge retrieval -> stage 2 seeded from stage 1, through
    the port's CLI on the CPU (tests/test_cli.py's chain without heatmaps)."""
    root = str(tmp_path)
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=2,
                                             image_size=32)
    common = ["--device", "cpu", "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results"),
              "--model.d_model", "32", "--model.d_ff", "64", "--model.num_heads", "2",
              "--model.num_layers", "1", "--model.rm_num_slots", "2",
              "--model.rm_d_model", "32", "--model.fusion_num_heads", "2",
              "--model.fusion_intermediate_size", "64", "--decode.beam_size", "2",
              "--trainer.epochs", "1"] + CLI_TINY
    assert tcli.main(["pretrain", "--data.ann_path", ann, "--trainer.version", "s1"]
                     + common) == 0
    s1 = os.path.join(root, "results", "mimic_cxr", "pretrain", "s1", "checkpoint", "current")
    assert os.path.isfile(os.path.join(s1, "state.pt"))
    assert tcli.main(["retrieve", "--data.ann_path", ann, "--trainer.version", "ret",
                      "--trainer.load", s1] + common + ["--data.retrieve_topk", "2"]) == 0
    aug = ann.replace(".json", "_best_reports_keywords_2.json")
    assert all(len(it["specific_knowledge"]["sk_ids"]) == 2
               for split in ("train", "val", "test") for it in json.load(open(aug))[split])
    assert tcli.main(["finetune", "--data.ann_path", aug, "--trainer.version", "s2",
                      "--trainer.load", s1] + common) == 0
    s2 = os.path.join(root, "results", "mimic_cxr", "finetune", "s2")
    assert os.path.exists(os.path.join(s2, "test_prediction.csv"))
    log = open(os.path.join(s2, "finetune.log")).read()
    report = json.loads(log.split("partial load from " + s1 + ": ")[1].splitlines()[0]
                        .replace("'", '"'))
    assert report["loaded"] > 50 and report["skipped"] == 0
    shutil.rmtree(os.path.join(root, "results"))
