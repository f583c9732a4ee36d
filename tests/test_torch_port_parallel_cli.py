"""Port parity: ``cli serve --device cpu --decode.serve_dp 2``.

The port's CLI runs in a process of its own and spawns two gloo ranks; on
both engines it gives the JAX CLI's id-to-report map at
``--decode.serve_dp 2`` (tests/test_cli.py:199) with the JAX CLI's weights,
and the same CSV rows as the port's own ``serve_dp 0``. Rank 0 alone
prints the summary and writes the CSV."""

import csv
import os
import subprocess
import sys

from evoke_tpu import cli as jcli
from evoke_tpu.core import config as jconfig
from evoke_tpu.data import datasets as jdatasets
from evoke_tpu.data import synthetic as jsynthetic
from evoke_tpu.data import tokenizer as jtokenizer
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.params import flax_to_state_dict

from test_torch_port_cli import TINY as CLI_TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_serve_cli_over_dp_matches_jax_cli(tmp_path, capsys):
    """The JAX CLI at --decode.serve_dp 2 (continuous, as tests/test_cli.py
    runs it) and the port's CLI in a process of its own, spawning 2 gloo
    ranks, on both engines, with the JAX CLI's weights; serve_dp 0 too."""
    root = str(tmp_path)
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=5,
                                             image_size=32, seed=2)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results"),
              "--decode.slots", "2", "--decode.seg_steps", "4"] + CLI_TINY
    assert jcli.main(["serve", "--trainer.version", "jax", "--decode.engine", "continuous",
                      "--decode.serve_dp", "2"] + common) == 0
    assert "serving mesh: dp=2" in capsys.readouterr().out
    cfg = jconfig.load_config(None, overrides={"trainer.task": "serve"}, argv=common)
    tok = jtokenizer.build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name, ann_path=ann)
    model = jcli.build_model(cfg, tok.get_vocab_size(), "finetune")
    loaders = jcli.build_loaders(cfg, tok, jdatasets.load_annotation(ann), "serve")
    state, _ = jcli.init_finetune_state(cfg, model, loaders)
    weights = os.path.join(root, "weights.pt")
    tcheckpoint.save_state_dict(flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}), weights)
    res = os.path.join(root, "results", "mimic_cxr", "serve")
    want = {r[0]: r[1] for r in _rows(os.path.join(res, "jax", "serve_prediction.csv"))[1:]}
    assert len(want) == 5
    got = {}
    for dp, engine in (("2", "batch"), ("2", "continuous"), ("0", "batch")):
        version = f"torch_{dp}_{engine}"
        out = subprocess.run(
            [sys.executable, "-m", "evoke_tpu_torch.cli", "serve", "--device", "cpu",
             "--trainer.version", version, "--trainer.load", weights, "--decode.engine",
             engine, "--decode.serve_dp", dp] + common,
            capture_output=True, text=True, timeout=200, cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr[-3000:]
        assert ("serving mesh: dp=2" in out.stdout) == (dp == "2")
        assert out.stdout.count('"reports": 5') == 1, out.stdout     # rank 0 alone prints
        rows = _rows(os.path.join(res, version, "serve_prediction.csv"))
        assert {r[0]: r[1] for r in rows[1:]} == want, (dp, engine)
        got[(dp, engine)] = rows
    assert got[("2", "batch")] == got[("2", "continuous")] == got[("0", "batch")]
