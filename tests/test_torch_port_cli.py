"""Port parity: the serve CLI and its data pipeline (config, tokenizer,
annotation parsing, synthetic data, transforms, batching, the state-dict
loader), each against its JAX counterpart on the same inputs, at
tests/test_cli.py's TINY dims (with the fusion attention narrowed to
d_vf / heads, so the end-to-end test stays well inside its time).

The end-to-end test runs the JAX CLI's ``serve`` and the port's
``serve --device cpu`` with the same weights (the JAX CLI's own seeded init,
converted) and requires identical ``serve_prediction.csv`` rows at float32."""

import csv
import dataclasses
import os

import numpy as np
import pytest
import torch

from evoke_tpu import cli as jcli
from evoke_tpu.core import config as jconfig
from evoke_tpu.data import batching as jbatching
from evoke_tpu.data import datasets as jdatasets
from evoke_tpu.data import synthetic as jsynthetic
from evoke_tpu.data import tokenizer as jtokenizer
from evoke_tpu.data import transforms as jtransforms
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.core import config as tconfig
from evoke_tpu_torch.data import batching as tbatching
from evoke_tpu_torch.data import datasets as tdatasets
from evoke_tpu_torch.data import synthetic as tsynthetic
from evoke_tpu_torch.data import tokenizer as ttokenizer
from evoke_tpu_torch.data import transforms as ttransforms
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


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    return root, jsynthetic.write_synthetic_dataset(root, n_train=6, n_val=2, n_test=5,
                                                    image_size=32, seed=3)


def _tokenizers(root, ann):
    jt = jtokenizer.build_tokenizer(os.path.join(root, "tok_j"), "mimic_cxr", ann_path=ann)
    tt = ttokenizer.build_tokenizer(os.path.join(root, "tok_t"), "mimic_cxr", ann_path=ann)
    return jt, tt


# ---- config ----

def test_config_defaults_equal():
    assert dataclasses.asdict(tconfig.EvokeConfig()) == dataclasses.asdict(
        jconfig.EvokeConfig())


@pytest.mark.parametrize("with_yaml", [False, True])
def test_config_overrides_equal(tmp_path, with_yaml):
    yaml_path = None
    if with_yaml:
        yaml_path = str(tmp_path / "c.yaml")
        with open(yaml_path, "w") as f:
            f.write("model:\n  d_model: 64\n  dtype: bfloat16\nbatch_size: 7\n"
                    "trainer:\n  version: y1\n")
    argv = TINY + ["--decode.suppress_unk", "--max_seq_len=24", "--trainer.seed", "5",
                   "--model.fusion_max_partners", "3"]
    kw = dict(overrides={"trainer.task": "serve"}, argv=argv)
    jc = jconfig.load_config(yaml_path, **kw)
    tc = tconfig.load_config(yaml_path, **kw)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.result_dir == jc.result_dir
    assert tc.decode.suppress_unk and tc.data.max_seq_len == 24
    assert (tc.model.dtype == "bfloat16") == with_yaml


def test_config_typo_raises():
    for load in (jconfig.load_config, tconfig.load_config):
        with pytest.raises(ValueError, match="model.d_modle"):
            load(argv=["--model.d_modle", "8"])


# ---- data pipeline ----

def test_build_tokenizer_same_vocab(dataset):
    root, ann = dataset
    jt, tt = _tokenizers(root, ann)
    assert tt.vocab == jt.vocab and tt.get_vocab_size() == jt.get_vocab_size()
    # the second call loads the saved file, in either package's format
    again = ttokenizer.build_tokenizer(os.path.join(root, "tok_j"), "mimic_cxr")
    assert again.vocab == jt.vocab


def test_parse_annotation_equal(dataset):
    _, ann_path = dataset
    ja, ta = jdatasets.load_annotation(ann_path), tdatasets.load_annotation(ann_path)
    assert ja == ta
    for split in ("train", "val", "test"):
        jh, jn = jdatasets.parse_finetune(ja, split)
        th, tn = tdatasets.parse_finetune(ta, split)
        assert [dataclasses.asdict(e) for e in th + tn] == \
            [dataclasses.asdict(e) for e in jh + jn]
        jp = jdatasets.parse_pretrain(ja, split, "keywords")
        tp = tdatasets.parse_pretrain(ta, split, "keywords")
        assert [dataclasses.asdict(e) for e in tp] == [dataclasses.asdict(e) for e in jp]


def test_write_synthetic_dataset_identical(tmp_path):
    kw = dict(n_train=3, n_val=1, n_test=2, image_size=16, seed=11)
    ja = jsynthetic.write_synthetic_dataset(str(tmp_path / "j"), **kw)
    ta = tsynthetic.write_synthetic_dataset(str(tmp_path / "t"), **kw)
    jfiles = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "j")
                    for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    tfiles = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                    for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert jfiles == tfiles and len(jfiles) > 6
    for f in jfiles:
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f
    assert os.path.basename(ja) == os.path.basename(ta)
    rng_j, rng_t = np.random.default_rng(2), np.random.default_rng(2)
    assert jsynthetic.synthetic_report(rng_j) == tsynthetic.synthetic_report(rng_t)


@pytest.mark.parametrize("output_uint8", [False, True])
@pytest.mark.parametrize("src_size,size", [(32, 32), (40, 32), (24, 32)])
def test_image_transform_npy_equal(tmp_path, output_uint8, src_size, size):
    img = np.random.default_rng(src_size).normal(size=(src_size, src_size, 3))
    np.save(tmp_path / "x.npy", img.astype(np.float32))
    jx = jtransforms.load_image("x.npy", str(tmp_path))
    tx = ttransforms.load_image("x.npy", str(tmp_path))
    jo = jtransforms.make_transform(size, False, output_uint8=output_uint8)(jx)
    to = ttransforms.make_transform(size, False, output_uint8=output_uint8)(tx)
    assert to.dtype == jo.dtype and to.shape == (size, size, 3)
    np.testing.assert_array_equal(to, jo)


@pytest.mark.parametrize("with_indication", [True, False])
def test_multiview_batcher_equal(dataset, with_indication):
    root, ann_path = dataset
    jt, tt = _tokenizers(root, ann_path)
    ann = jdatasets.load_annotation(ann_path)
    exs = sum(jdatasets.parse_finetune(ann, "train"), [])
    texs = sum(tdatasets.parse_finetune(ann, "train"), [])
    kw = dict(n_anchor=2, n_aux_slots=1, max_seq_len=16, image_dir=root, num_workers=2,
              with_indication=with_indication, text_field="report", add_bos_eos=True)
    jb = jbatching.MultiviewBatcher(exs, jt, jtransforms.make_transform(32, False, True), **kw)
    tb = tbatching.MultiviewBatcher(texs, tt, ttransforms.make_transform(32, False, True),
                                    **kw)
    jbs, tbs = list(jb), list(tb)
    assert len(tbs) == len(jbs) == len(tb) == 3
    for j, t in zip(jbs, tbs):
        assert sorted(t) == sorted(j)
        assert ("inc_ids" in t) == with_indication
        for key in j:
            if key.startswith("_"):
                assert t[key] == j[key], key
            else:
                assert t[key].dtype == j[key].dtype, key
                np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert tb.aux_dropped == jb.aux_dropped > 0    # one aux slot: some views dropped


def test_state_dict_loader_round_trip(tmp_path):
    """flax variables -> flax_to_state_dict -> torch.save -> partial restore."""
    import jax

    from evoke_tpu.models.heads import ProjectionHead as JHead
    from evoke_tpu_torch.models.heads import ProjectionHead as THead

    x = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    jm = JHead(12, 6, final_bn=True)
    v = jax.device_get(jm.init(jax.random.key(0), x))
    sd = flax_to_state_dict(v)
    sd["not_in_model.weight"] = np.zeros(3, np.float32)
    path = str(tmp_path / "w.pt")
    tcheckpoint.save_state_dict(sd, path)
    tm = THead(8, 12, 6, final_bn=True).eval()
    report = tcheckpoint.partial_restore_from(path, tm)
    assert report == {"loaded": len(sd) - 1, "missing": 0, "skipped": 1}
    for k, val in tm.state_dict().items():
        np.testing.assert_array_equal(val.numpy(), sd[k], err_msg=k)
    np.testing.assert_allclose(tm(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jm.apply(v, x)), rtol=1e-5, atol=1e-5)
    # a shape mismatch is skipped and the target keeps its value
    first = next(iter(tm.state_dict()))
    sd[first] = np.zeros((1, 1), np.float32)
    tcheckpoint.save_state_dict(sd, path)
    report = tcheckpoint.partial_restore_from(path, tm)
    assert report == {"loaded": len(sd) - 2, "missing": 0, "skipped": 2}


# ---- the CLI ----

def test_cli_help_unknown_and_unported(dataset, capsys, tmp_path, monkeypatch):
    assert tcli.main([]) == 0
    assert "serve" in capsys.readouterr().out
    assert tcli.main(["frobnicate"]) == 2
    root, ann = dataset
    assert tcli.main(["finetune", "--device", "cpu", "--data.ann_path", ann,
                      "--data.image_dir", root, "--data.tokenizer_dir", str(tmp_path / "tok"),
                      "--trainer.result_dir", str(tmp_path)] + TINY) == 0
    assert os.path.exists(os.path.join(str(tmp_path), "mimic_cxr", "finetune", "v1",
                                       "checkpoint", "current", "state.pt"))
    assert tcli.main(["pretrain", "--device", "cpu", "--data.ann_path", ann,
                      "--data.image_dir", root, "--data.tokenizer_dir", str(tmp_path / "tok"),
                      "--trainer.result_dir", str(tmp_path)] + TINY) == 0
    assert os.path.exists(os.path.join(str(tmp_path), "mimic_cxr", "pretrain", "v1",
                                       "checkpoint", "current", "state.pt"))
    with pytest.raises(ValueError, match="decode.engine='frobnicate'"):
        tcli.main(["serve", "--device", "cpu", "--decode.engine", "frobnicate"])
    with pytest.raises(ValueError, match="decode.serve_dp=-2"):
        tcli.main(["serve", "--device", "cpu", "--decode.serve_dp", "-2"])
    # a serving mesh never takes more cards than are visible (JAX's create_mesh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tcli.main(["serve", "--data.ann_path", ann, "--decode.serve_dp", "2"] + TINY)
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcli.main(["serve", "--device", "cpu", "--model.d_modle", "8"])


def test_cli_raises_without_cuda_unless_device_cpu(dataset, monkeypatch):
    root, ann = dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["serve", "--data.ann_path", ann] + TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["serve", "--data.ann_path", ann, "--device=cuda"] + TINY)


def test_cli_serve_grouped_fusion_from_argv(dataset, tmp_path, capsys):
    """--model.fusion_max_partners arrives as a string from argv (the config's
    default is None, so _coerce keeps the text, as in the JAX package); the
    port's build_model makes it an int, so serving can check its bound."""
    root, ann = dataset
    assert tcli.main(["serve", "--data.ann_path", ann, "--data.image_dir", root,
                      "--data.tokenizer_dir", str(tmp_path / "tok"),
                      "--trainer.result_dir", str(tmp_path / "res"), "--device", "cpu",
                      "--model.fusion_max_partners", "1"] + TINY) == 0
    assert '"reports": 5' in capsys.readouterr().out


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_serve_cli_matches_jax_cli(tmp_path, capsys):
    """Both CLIs serve the same synthetic test split with the same float32
    weights and write the same serve_prediction.csv rows."""
    root = str(tmp_path)
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=5,
                                             image_size=32, seed=1)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results")] + TINY
    assert jcli.main(["serve", "--trainer.version", "jax"] + common) == 0
    # the JAX CLI's weights: its own seeded init (init_finetune_state), converted
    cfg = jconfig.load_config(None, overrides={"trainer.task": "serve"}, argv=common)
    tok = jtokenizer.build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name,
                                     ann_path=ann)
    model = jcli.build_model(cfg, tok.get_vocab_size(), "finetune")
    loaders = jcli.build_loaders(cfg, tok, jdatasets.load_annotation(ann), "serve")
    state, _ = jcli.init_finetune_state(cfg, model, loaders)
    weights = os.path.join(root, "weights.pt")
    tcheckpoint.save_state_dict(flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}), weights)
    capsys.readouterr()
    assert tcli.main(["serve", "--trainer.version", "torch", "--trainer.load", weights,
                      "--device", "cpu"] + common) == 0
    out = capsys.readouterr().out
    assert "'missing': 0, 'skipped': 0" in out
    res = os.path.join(root, "results", "mimic_cxr", "serve")
    want = _rows(os.path.join(res, "jax", "serve_prediction.csv"))
    got = _rows(os.path.join(res, "torch", "serve_prediction.csv"))
    assert got[0] == ["images_id", "generated_reports", "ground_truth"]
    assert len(got) == 6 and all(r[1].strip() for r in got[1:])
    assert got == want
