"""Port parity: the ``test`` and ``score`` tasks and the modules they reach
(config save, loggers, NLG and METEOR metrics, the metric adapters' failure
path, CheXbert, the composite scorer, the Tester), each against its JAX
counterpart on the same seeded inputs, at toy sizes on the CPU.

Tolerances: the NLG metrics, METEOR and the classification report are the
same Python / numpy arithmetic in both packages and must agree to 1e-12
(they agree exactly); CheXbert labels must be equal, and the labeler's logits
within 1e-5 of HF ``BertModel`` at float32. The CLI's files must be equal
byte for byte (``config.json`` up to the ``trainer.load`` path, which only
the port's run sets)."""

import csv
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp
from test_golden_metrics import PATHS as GOLDEN_PATHS

from evoke_tpu import cli as jcli
from evoke_tpu.core import config as jconfig
from evoke_tpu.core import loggers as jloggers
from evoke_tpu.data import synthetic as jsynthetic
from evoke_tpu.evals import composite as jcomposite
from evoke_tpu.evals import meteor as jmeteor
from evoke_tpu.evals import nlg as jnlg
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.core import config as tconfig
from evoke_tpu_torch.core import loggers as tloggers
from evoke_tpu_torch.evals import chexbert as tchexbert
from evoke_tpu_torch.evals import composite as tcomposite
from evoke_tpu_torch.evals import meteor as tmeteor
from evoke_tpu_torch.evals import nlg as tnlg
from evoke_tpu_torch.params import flax_to_state_dict

torch.set_num_threads(2)

TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.d_model", "32",
    "--model.d_ff", "64", "--model.num_heads", "2", "--model.num_layers", "1",
    "--model.rm_num_slots", "2", "--model.rm_d_model", "32",
    "--model.fusion_num_heads", "2", "--model.fusion_intermediate_size", "64",
    "--model.image_size", "32", "--data.max_seq_len", "16",
    "--data.batch_size", "2", "--data.num_workers", "2",
    "--trainer.epochs", "1", "--trainer.log_interval", "1000",
    "--decode.beam_size", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
]

WORDS = ("the heart is normal in size . lungs lung are clear no acute effusion effusions "
         "pleural pneumothorax mild cardiomegaly present noted atelectasis bibasilar focal "
         "consolidation consolidations cardiac of with there left right small").split()


def text_sets(seed, n):
    """Seeded (gts, res) dicts over a vocabulary with stems in common."""
    rng = np.random.default_rng(seed)
    sent = lambda: " ".join(rng.choice(WORDS, size=int(rng.integers(1, 25))))
    gts = {f"s{i}": [sent()] for i in range(n)}
    res = {k: [sent() if rng.random() < 0.8 else v[0]] for k, v in gts.items()}
    return gts, res


def assert_close(got, want, tol=1e-12):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_close(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, tol)
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=tol, abs_tol=tol), (got, want)
    else:
        assert got == want


# ---- config ----

def test_config_save_and_monitor_fields_equal(tmp_path):
    for task in ("test", "pretrain"):
        argv = TINY + ["--trainer.ft_monitor_metric", "BLEU_4", "--metrics.chexbert_checkpoint",
                       "/x/chexbert.pth"]
        jc = jconfig.load_config(None, overrides={"trainer.task": task}, argv=argv)
        tc = tconfig.load_config(None, overrides={"trainer.task": task}, argv=argv)
        jc.vocab_size = tc.vocab_size = 77
        jc.save(str(tmp_path / "j.json"))
        tc.save(str(tmp_path / "t.json"))
        assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
        assert tc.to_dict() == jc.to_dict()
        for name in ("monitor_mode", "monitor_metric", "lr_monitor_metric"):
            assert getattr(tc, name) == getattr(jc, name), name


# ---- NLG metrics and METEOR ----

@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 40)])
def test_nlg_metrics_equal(seed, n):
    gts, res = text_sets(seed, n)
    assert_close(tnlg.bleu(gts, res, 4), jnlg.bleu(gts, res, 4))
    assert_close(tnlg.rouge_l(gts, res), jnlg.rouge_l(gts, res))
    assert_close(tnlg.cider_d(gts, res), jnlg.cider_d(gts, res))
    assert_close(tnlg.meteor_lite(gts, res), jnlg.meteor_lite(gts, res))
    assert_close(tnlg.compute_nlg_scores(gts, res), jnlg.compute_nlg_scores(gts, res))
    lists = ([v[0] for v in gts.values()], [v[0] for v in res.values()])
    assert_close(tnlg.compute_nlg_scores(*lists), jnlg.compute_nlg_scores(*lists))
    assert tnlg._FUNC_WORDS == jnlg._FUNC_WORDS
    assert [tnlg._stem(w) for w in WORDS] == [jnlg._stem(w) for w in WORDS]


@pytest.mark.parametrize("kw", [{}, {"stemmer": "snowball"}, {"chunk_preference": True}])
@pytest.mark.parametrize("gz", [False, True])
def test_meteor15_stages_equal(tmp_path, kw, gz):
    """Every stage: exact, stem, synonym (WordNet when nltk has it on disk,
    else a stand-in table given to both) and a paraphrase table."""
    import gzip

    path = tmp_path / ("para.gz" if gz else "para.txt")
    with (gzip.open(path, "wt") if gz else open(path, "w")) as f:
        f.write("heart ||| cardiac\nlungs ||| lung fields\nclear ||| normal\n")
    t = tmeteor.Meteor15(paraphrase_path=str(path), **kw)
    j = jmeteor.Meteor15(paraphrase_path=str(path), **kw)
    if j.synsets is None:       # no WordNet on disk: one synonym table for both
        table = {"effusion": {"fluid"}, "fluid": {"fluid"}, "small": {"little"}}
        syn = lambda w: frozenset(table.get(w, ())) | {w}
        for m in (t, j):
            m.synsets = syn
            m.stages.insert(2, ("synonym", 0.8))
    assert t.stages == j.stages and [s for s, _ in t.stages][-1] == "paraphrase"
    for seed in (3, 4):
        gts, res = text_sets(seed, 12)
        assert_close(t(gts, res), j(gts, res))
    pair = ("cardiac size normal with little fluid".split(),
            "heart size clear with small effusion".split())
    assert t.score_pair(*pair) == j.score_pair(*pair) > 0


def test_meteor_helpers_equal(tmp_path, monkeypatch):
    for env in ("EVOKE_METEOR_PARAPHRASE", "EVOKE_METEOR_DATA", "EVOKE_METEOR_JAR"):
        monkeypatch.delenv(env, raising=False)
    assert tmeteor.default_paraphrase_path() is None is jmeteor.default_paraphrase_path()
    (tmp_path / "paraphrase-en.txt").write_text("a ||| b\n")
    monkeypatch.setenv("EVOKE_METEOR_DATA", str(tmp_path))
    assert tmeteor.default_paraphrase_path() == jmeteor.default_paraphrase_path() == str(
        tmp_path / "paraphrase-en.txt")
    gts, res = text_sets(5, 6)
    assert_close(tmeteor.meteor(gts, res), jmeteor.meteor(gts, res))
    # a jar that cannot start: both fall back to the pure-Python scorer
    monkeypatch.setenv("EVOKE_METEOR_JAR", str(tmp_path / "missing.jar"))
    monkeypatch.setattr(tnlg, "_METEOR15", None)
    monkeypatch.setattr(jnlg, "_METEOR15", None)
    assert type(tnlg._meteor15()).__name__ == type(jnlg._meteor15()).__name__ == "Meteor15"
    assert tnlg._meteor15().paraphrases == jnlg._meteor15().paraphrases == {"a": {"b"},
                                                                            "b": {"a"}}
    with pytest.raises(RuntimeError, match="MeteorJar"):
        tmeteor.MeteorJar(str(tmp_path / "missing.jar"))


GOLDEN = GOLDEN_PATHS["224x224"]     # the reference CSVs, where they are on disk


@pytest.mark.skipif(not os.path.exists(GOLDEN), reason="reference CSVs unavailable")
def test_nlg_metrics_equal_on_reference_csv():
    import pandas as pd

    df = pd.read_csv(GOLDEN, dtype=str)
    data = df[~df["ground_truth"].isna()]
    gts = {r["images_id"]: [str(r["ground_truth"])] for _, r in data.iterrows()}
    res = {r["images_id"]: [str(r["generated_reports"])] for _, r in data.iterrows()}
    assert_close(tnlg.compute_nlg_scores(gts, res), jnlg.compute_nlg_scores(gts, res))


# ---- classification report (sklearn's, in numpy) ----

def _sk_report(y_true, y_pred, names):
    from sklearn.metrics import accuracy_score, classification_report

    return (classification_report(y_true, y_pred, target_names=names, output_dict=True,
                                  zero_division=0), accuracy_score(y_true, y_pred))


def _check_report(y_true, y_pred):
    names = [f"c{i}" for i in range(y_true.shape[1])]
    want, want_acc = _sk_report(y_true, y_pred, names)
    got = tchexbert.classification_report(y_true, y_pred, target_names=names)
    assert_close(got, want)
    assert all(type(v) is float for row in got.values() for v in row.values())
    assert tchexbert.accuracy_score(y_true, y_pred) == want_acc


@settings(max_examples=60, deadline=None)
@given(st.integers(2, 14).flatmap(lambda c: st.tuples(
    hnp.arrays(np.int64, st.tuples(st.integers(1, 12), st.just(c)), elements=st.integers(0, 1)),
    st.integers(0, 2 ** 31 - 1))))
def test_classification_report_matches_sklearn(case):
    y_true, seed = case
    rng = np.random.default_rng(seed)
    y_pred = (rng.random(y_true.shape) < 0.4).astype(np.int64)
    y_pred[:, rng.integers(0, y_true.shape[1])] = 0          # an all-zero column
    _check_report(y_true, y_pred)


@pytest.mark.parametrize("kind", ["all_zero", "true_zero", "pred_zero", "equal"])
def test_classification_report_edge_cases(kind):
    rng = np.random.default_rng(7)
    y = (rng.random((6, 14)) < 0.5).astype(np.int64)
    zero = np.zeros_like(y)
    y_true, y_pred = {"all_zero": (zero, zero), "true_zero": (zero, y),
                      "pred_zero": (y, zero), "equal": (y, y)}[kind]
    _check_report(y_true, y_pred)


# ---- loggers ----

def _prediction_writes(mod, path):
    csvf = mod.PredictionCSV(str(path))
    out = []
    csvf.update("1", ["s2", "3f9a", "Zb", "a,b"], ["gt one", 'a "q"', "NA", ""],
                ["p1", "p,2", "None", "x\ny"],
                {"BLEU_1": 0.1, "METEOR": np.float64(1 / 3), "degraded_metrics": "x: y"})
    out.append(path.read_bytes())
    csvf.update("2", ["s2", "3f9a", "10c"], ["gt one", "NA", "g"], ["q1", "q2", "q3"],
                {"BLEU_1": 0.25, "CIDer": 1e-20})
    out.append(path.read_bytes())
    csvf.update("1", ["s2"], ["gt one"], ["r1"], {"BLEU_1": 0.5})
    out.append(path.read_bytes())
    return out


def test_prediction_csv_bytes_equal(tmp_path):
    """A first write, then two merges (one replacing an epoch's column) with
    digit- and upper-case-leading ids, which pandas' merge sorts before the
    metric rows."""
    want = _prediction_writes(jloggers, tmp_path / "j.csv")
    got = _prediction_writes(tloggers, tmp_path / "t.csv")
    assert got == want
    assert want[1].decode().splitlines()[1].startswith("10c,")
    small = tmp_path / "m.csv"
    for mod in (jloggers, tloggers):
        if small.exists():
            small.unlink()
        pc = mod.PredictionCSV(str(small))
        pc.update("1", ["7a", "s1"], ["g", "h"], ["p", "q"], {"B": 0.5})
        pc.update("2", ["7a", "s1"], ["g", "h"], ["p", "q"], {"B": 0.25, "C": 1.0})
        got_m = tloggers.PredictionCSV.read_metrics(str(small))
        assert got_m == jloggers.PredictionCSV.read_metrics(str(small))
    assert got_m == {"B": {"pred_1": 0.5, "pred_2": 0.25}, "C": {"pred_2": 1.0}}


def test_best_record_and_metric_writer_equal(tmp_path):
    recs = [{"val_BLEU_4": 0.25, "test_x": -np.inf, "note": "a,b", "none": None,
             "nan": float("nan"), "seed": 3, "flag": True}, {"val_BLEU_4": 0.5, "z": 1}]
    for mod, name in ((jloggers, "j"), (tloggers, "t")):
        for r in recs:
            mod.append_best_record(str(tmp_path / f"{name}.csv"), r)
        mod.MetricWriter(str(tmp_path / f"{name}.jsonl")).write({"event": "test", "a": 0.5})
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    strip = lambda p: {k: v for k, v in json.loads(p.read_text()).items() if k != "ts"}
    assert strip(tmp_path / "t.jsonl") == strip(tmp_path / "j.jsonl")


# ---- CheXbert ----

CHEX_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "heart", "is", "normal",
              "lungs", "clear", "no", "acute", "effusion", "pleural", "edema", "##s", "card",
              "##iomegaly", "small", "left", "right", "there", "of", "with", "mild", ".",
              "in", "size", "are", "pneumothorax", "abnormality", "present", "noted",
              "atelectasis", "focal", "consolidation", "or", "evidence", "pulmonary"]
CHEX_DIMS = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                 max_positions=64)
REPORTS = ["the heart is normal . lungs clear .",
           "small left pleural effusion with mild cardiomegaly .",
           "no acute edema .", "there is no evidence of pulmonary.",
           "focal consolidation noted in the left lungs .", "atelectasis ."]


@pytest.fixture(scope="module")
def fake_chexbert(tmp_path_factory):
    """An HF BertModel (2 layers, 32 wide) + 14 heads saved as chexbert.pth
    ('model_state_dict', 'module.' prefix), as tests/test_chexbert.py makes it."""
    from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    root = tmp_path_factory.mktemp("chexbert")
    (root / "vocab.txt").write_text("\n".join(CHEX_VOCAB) + "\n")
    cfg = BertConfig(vocab_size=len(CHEX_VOCAB), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    bert = BertModel(cfg).eval()
    heads = [torch.nn.Linear(32, 4 if i < 13 else 2) for i in range(14)]
    with torch.no_grad():
        for h in heads:          # logits far enough apart that argmax is stable
            h.weight.mul_(20.0)
    sd = {f"module.bert.{k}": v for k, v in bert.state_dict().items()}
    for i, h in enumerate(heads):
        sd[f"module.linear_heads.{i}.weight"] = h.weight.detach()
        sd[f"module.linear_heads.{i}.bias"] = h.bias.detach()
    torch.save({"model_state_dict": sd}, root / "chexbert.pth")
    return str(root / "chexbert.pth"), str(root), bert, heads


@pytest.fixture(scope="module")
def scorers(fake_chexbert):
    """(JAX F1CheXbert, the port's on the CPU) over the fake checkpoint."""
    from evoke_tpu.evals.chexbert import F1CheXbert as JF1

    ck, root, _, _ = fake_chexbert
    kw = dict(max_len=32, batch_size=4, **CHEX_DIMS)
    return JF1(ck, root, **kw), tchexbert.F1CheXbert(ck, root, device="cpu", **kw)


def test_chexbert_labels_match_jax_and_hf(fake_chexbert, scorers):
    ck, root, bert, heads = fake_chexbert
    j, t = scorers
    assert t.import_report == {k: j.import_report[k] for k in ("loaded", "mismatched",
                                                               "missing")}
    assert t.import_report["mismatched"] == 0 and t.import_report["loaded"] == 37
    reports = REPORTS * 2                     # 12 reports: 3 batches, the last padded
    got = t.label(reports)
    np.testing.assert_array_equal(got, j.label(reports))
    ids = np.stack([t._encode(r) for r in reports])
    mask = ids != t.tokenizer.pad_id
    with torch.no_grad():
        hf = bert(input_ids=torch.as_tensor(ids, dtype=torch.long),
                  attention_mask=torch.as_tensor(mask, dtype=torch.long)
                  ).last_hidden_state[:, 0]
        want = torch.cat([h(hf) for h in heads], 1)
        mine = torch.cat(t.model(torch.as_tensor(ids), torch.as_tensor(mask.astype(np.int32))),
                         1)
    np.testing.assert_allclose(mine.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    cls = np.stack([want[:, a:b].argmax(1).numpy() for a, b in zip(
        range(0, 56, 4), list(range(4, 53, 4)) + [54])], 1)
    np.testing.assert_array_equal(got, ((cls == 1) | (cls == 3)).astype(np.int64))
    assert_close(t(hyps=reports[::-1], refs=reports)[2:], j(hyps=reports[::-1], refs=reports)[2:])


def test_chexbert_details_and_scores_equal(fake_chexbert, scorers, monkeypatch):
    ck, root, _, _ = fake_chexbert
    j, t = scorers
    cfg_j = jconfig.MetricsConfig(chexbert_checkpoint=ck, chexbert_tokenizer_checkpoint=root)
    cfg_t = tconfig.MetricsConfig(chexbert_checkpoint=ck, chexbert_tokenizer_checkpoint=root)
    monkeypatch.setitem(jcomposite._SCORER_CACHE, f"chexbert:{ck}", j)
    monkeypatch.setitem(tcomposite._SCORER_CACHE, f"chexbert:{ck}:cpu", t)
    hyps = REPORTS[1:] + REPORTS[:1]
    got = tcomposite.compute_chexbert_details_scores(REPORTS, hyps, cfg_t, device="cpu")
    assert got == jcomposite.compute_chexbert_details_scores(REPORTS, hyps, cfg_j)
    got = tcomposite.compute_all_scores(REPORTS, hyps, cfg_t, device="cpu")
    assert_close(got, jcomposite.compute_all_scores(REPORTS, hyps, cfg_j))
    assert "chexbert_all_micro_f1" in got and "degraded_metrics" not in got


def test_ce_scores_degrade_alike(tmp_path, monkeypatch, capsys):
    """Missing radgraph, a GREEN path that is not there, and a CheXbert the
    device cannot hold (CUDA asked for where there is none) land in the same
    degraded_metrics string in both packages, apart from CheXbert, which only
    the port runs on a device."""
    monkeypatch.setitem(sys.modules, "radgraph", None)
    kw = dict(radgraph_checkpoint="rg", green_checkpoint=str(tmp_path / "no_green"))
    got = tcomposite.compute_ce_scores(["a b"], ["a c"], tconfig.MetricsConfig(**kw),
                                       device="cpu")
    want = jcomposite.compute_ce_scores(["a b"], ["a c"], jconfig.MetricsConfig(**kw))
    assert got == want and "F1-Radgraph:" in got["degraded_metrics"]
    ck = str(tmp_path / "chexbert.pth")
    open(ck, "w").close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = tcomposite.compute_ce_scores(["a"], ["a"], tconfig.MetricsConfig(
        chexbert_checkpoint=ck))
    assert got["degraded_metrics"].startswith("CheXbert: device 'cuda' requested")


# ---- the CLI ----

def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, fake_chexbert, scorers):
    """The JAX CLI's ``test`` and the port's ``test --device cpu`` on one
    synthetic split with the same float32 weights (the JAX CLI's own seeded
    init, converted) and a tiny CheXbert in each package's scorer cache."""
    ck, chex_root, _, _ = fake_chexbert
    root = str(tmp_path_factory.mktemp("eval_cli"))
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=7,
                                             image_size=32, seed=1)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results"),
              "--metrics.chexbert_checkpoint", ck] + TINY
    j, t = scorers
    res = os.path.join(root, "results", "mimic_cxr", "test", "v1")
    saved = dict(jcomposite._SCORER_CACHE), dict(tcomposite._SCORER_CACHE)
    jcomposite._SCORER_CACHE[f"chexbert:{ck}"] = j
    tcomposite._SCORER_CACHE[f"chexbert:{ck}:cpu"] = t
    init, states = jcli.init_finetune_state, []
    try:
        # the weights: those the JAX CLI initialises from its seed, kept here
        jcli.init_finetune_state = lambda *a: states.append(init(*a)) or states[-1]
        assert jcli.main(["test"] + common) == 0
        shutil.move(res, os.path.join(root, "jax"))
        (state, _), = states
        weights = os.path.join(root, "weights.pt")
        tcheckpoint.save_state_dict(flax_to_state_dict(
            {"params": state.params, "batch_stats": state.batch_stats}), weights)
        assert tcli.main(["test", "--device", "cpu", "--trainer.load", weights] + common) == 0
    finally:
        jcli.init_finetune_state = init
        for cache, old in zip((jcomposite._SCORER_CACHE, tcomposite._SCORER_CACHE), saved):
            cache.clear()
            cache.update(old)
    return dict(root=root, jax=os.path.join(root, "jax"), torch=res, weights=weights,
                ann=ann, common=common)


def test_test_cli_matches_jax_cli(cli_runs):
    jdir, tdir = cli_runs["jax"], cli_runs["torch"]
    want = open(os.path.join(jdir, "test_prediction.csv"), "rb").read()
    got = open(os.path.join(tdir, "test_prediction.csv"), "rb").read()
    assert got == want
    rows = _rows(os.path.join(tdir, "test_prediction.csv"))
    assert rows[0] == ["images_id", "ground_truth", "pred_test"]
    names = [r[1] for r in rows[1:] if r[0].startswith("__metric__")]
    assert names == ["BLEU_1", "BLEU_2", "BLEU_3", "BLEU_4", "METEOR", "ROUGE_L", "CIDer",
                     "chexbert_5_micro_f1", "chexbert_all_micro_f1", "chexbert_5_macro_f1",
                     "chexbert_all_macro_f1"]
    assert len(rows) == 1 + len(names) + 7 and all(r[2].strip() for r in rows[1:])
    jtext = open(os.path.join(jdir, "config.json")).read()
    ttext = open(os.path.join(tdir, "config.json")).read()
    assert ttext.replace(json.dumps(cli_runs["weights"]), '""') == jtext
    strip = lambda d: [{k: v for k, v in json.loads(line).items() if k != "ts"}
                       for line in open(os.path.join(d, "metrics.jsonl"))]
    assert strip(tdir) == strip(jdir) and len(strip(tdir)) == 1
    logged = lambda d: [line.split(" | ", 1)[1] for line in open(os.path.join(d, "test.log"))
                        if "\ttest_" in line]
    assert logged(tdir) == logged(jdir) and len(logged(tdir)) == len(names)


@pytest.mark.parametrize("kind", ["test_csv", "reference_csv", "json"])
def test_score_cli_matches_jax_cli(cli_runs, tmp_path, capsys, kind):
    path = os.path.join(cli_runs["torch"], "test_prediction.csv")
    if kind == "reference_csv":     # the reference's layout: metric rows, empty ground truth
        rows = _rows(path)
        path = str(tmp_path / "ref.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["images_id", "generated_reports", "ground_truth"])
            for r in rows[1:]:
                metric = r[0].startswith("__metric__")
                w.writerow([r[1] if metric else r[0], r[2], "" if metric else r[1]])
    elif kind == "json":
        gts, res = text_sets(9, 5)
        path = str(tmp_path / "p.json")
        with open(path, "w") as f:
            json.dump({"gts": {k: v[0] for k, v in gts.items()},
                       "res": {k: v[0] for k, v in res.items()}}, f)
    capsys.readouterr()
    assert jcli.main(["score", "--data.ann_path", path]) == 0
    want = capsys.readouterr().out
    assert tcli.main(["score", "--data.ann_path", path]) == 0
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["BLEU_1"] >= 0
    if kind == "test_csv":
        metrics = tloggers.PredictionCSV.read_metrics(path)
        for k, v in json.loads(got).items():
            assert metrics[k]["pred_test"] == v, k


def test_test_cli_without_pandas_sklearn_nltk_transformers(cli_runs, tmp_path, monkeypatch,
                                                          fake_chexbert):
    """The card's machine has none of these: the port's ``test`` must not need
    them (nltk's absence leaves METEOR at its exact + stem stages)."""
    ck, chex_root, _, _ = fake_chexbert
    for name in ("pandas", "sklearn", "sklearn.metrics", "nltk", "nltk.corpus",
                 "nltk.stem.snowball", "transformers"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(tnlg, "_METEOR15", None)
    scorer = tchexbert.F1CheXbert(ck, chex_root, max_len=32, batch_size=4, device="cpu",
                                  **CHEX_DIMS)
    monkeypatch.setitem(tcomposite._SCORER_CACHE, f"chexbert:{ck}:cpu", scorer)
    common = list(cli_runs["common"])
    common[common.index("--trainer.result_dir") + 1] = str(tmp_path)
    assert tcli.main(["test", "--device", "cpu", "--trainer.load", cli_runs["weights"]]
                     + common) == 0
    assert tnlg._METEOR15.synsets is None
    path = os.path.join(str(tmp_path), "mimic_cxr", "test", "v1", "test_prediction.csv")
    metrics = tloggers.PredictionCSV.read_metrics(path)
    assert len(metrics) == 11 and all(0 <= v["pred_test"] <= 10 for v in metrics.values())
    assert tcli.main(["score", "--data.ann_path", path]) == 0


def _pngs(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))


def test_test_cli_refusals(cli_runs, monkeypatch, scorers, fake_chexbert, tmp_path):
    """``--trainer.plot_heatmaps 2`` first: the port's test CLI writes the
    files JAX's writes (the same names; pixels within one level of 255: the
    attention maps agree to float32 rounding and a level boundary may fall
    between them), one PNG per decoder layer and generated word of the two
    studies drawn; then the refusals and --trainer.resume."""
    from PIL import Image

    common = cli_runs["common"]
    plain = common[:common.index("--metrics.chexbert_checkpoint")] + \
        common[common.index("--metrics.chexbert_checkpoint") + 2:]
    runs = {}
    for side in ("jax", "torch"):
        argv = list(plain)
        argv[argv.index("--trainer.result_dir") + 1] = str(tmp_path / f"heat_{side}")
        argv += ["--trainer.plot_heatmaps", "2"]
        if side == "jax":
            assert jcli.main(["test"] + argv) == 0
        else:
            assert tcli.main(["test", "--device", "cpu", "--trainer.load",
                              cli_runs["weights"]] + argv) == 0
        runs[side] = str(tmp_path / f"heat_{side}" / "mimic_cxr" / "test" / "v1" /
                         "attentions")
    names = _pngs(runs["torch"])
    assert names == _pngs(runs["jax"])
    studies = {n.split(os.sep)[0] for n in names}
    layers = int(plain[plain.index("--model.num_layers") + 1])
    assert len(studies) == 2 and {n.split(os.sep)[1] for n in names} == {
        f"layer_{i}" for i in range(layers)}
    preds = {r[0]: r[-1] for r in _rows(os.path.join(cli_runs["torch"],
                                                     "test_prediction.csv"))}
    assert len(names) == layers * sum(len(preds[s].split()) for s in studies)
    worst = 0
    for n in names:
        got = np.asarray(Image.open(os.path.join(runs["torch"], n)), np.int16)
        want = np.asarray(Image.open(os.path.join(runs["jax"], n)), np.int16)
        assert got.shape == want.shape == (32, 32, 3)
        worst = max(worst, int(np.abs(got - want).max()))
    assert worst <= 1, worst
    # --trainer.resume auto, as JAX's Tester does through BaseTrainer._resume:
    # no slot yet starts fresh; a slot's weights are restored
    monkeypatch.setitem(tcomposite._SCORER_CACHE, f"chexbert:{fake_chexbert[0]}:cpu",
                        scorers[1])
    argv = list(common)
    argv[argv.index("--trainer.result_dir") + 1] = str(tmp_path)
    assert tcli.main(["test", "--device", "cpu", "--trainer.resume", "auto"] + argv) == 0
    res = os.path.join(str(tmp_path), "mimic_cxr", "test", "v1")
    assert "resume=auto: no checkpoint yet" in open(os.path.join(res, "test.log")).read()
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState

    cfg = tconfig.load_config(None, overrides={"trainer.task": "test"}, argv=argv)
    vocab = json.load(open(os.path.join(cli_runs["torch"], "config.json")))["vocab_size"]
    model = tcli.build_model(cfg, vocab, "cpu")
    tcheckpoint.partial_restore_from(cli_runs["weights"], model)
    state = TrainState(model, build_optimizer("RAdam", "finetune", model, pt_lr=1e-3,
                                              ft_lr=1e-3, weight_decay=0.0))
    tcheckpoint.CheckpointManager(os.path.join(res, "checkpoint")).save(
        "current", state, {"epoch": 4})
    os.remove(os.path.join(res, "test_prediction.csv"))
    assert tcli.main(["test", "--device", "cpu", "--trainer.resume", "auto"] + argv) == 0
    assert "resumed from current: epoch 5" in open(os.path.join(res, "test.log")).read()
    assert open(os.path.join(res, "test_prediction.csv"), "rb").read() == open(
        os.path.join(cli_runs["torch"], "test_prediction.csv"), "rb").read()
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcli.main(["retrieve", "--device", "cpu", "--data.retrieve_tpok", "3"] + common)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["test"] + common)
