"""Port parity: serving over a data-parallel mesh, 2 gloo ranks on the CPU
against the JAX package on a dp=2 mesh of tests/conftest.py's virtual CPU
devices, at float32 (the rank bodies are in ``_torch_port_dp.py``):

- ``make_generate_step(mesh=)`` decodes each rank's anchors to JAX's dp=2
  tokens, and ``ReportServer(mesh=)`` serves JAX's dp=2 records on every
  rank (tests/test_parallel.py:101, :340; tests/test_serve.py:86);
- ``ContinuousServer(mesh=)``, each rank running half the slots over its
  rows of every batch, serves the JAX dp engine's reports
  (tests/test_parallel.py:166, :310);
- the CLI's ``--decode.serve_dp`` is held in test_torch_port_parallel_cli.py.

The loader's last batch is padded: one rank holds a padded anchor, and
every rank still pulls (and gathers) every batch.
"""

import numpy as np
import pytest
import torch

from evoke_tpu.core import mesh as jmesh
from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.data.tokenizer import WordTokenizer as JTok
from evoke_tpu.decode.continuous import ContinuousServer as JContinuous
from evoke_tpu.serve import ReportServer as JServer
from evoke_tpu.train.steps import TrainState, make_generate_step
from evoke_tpu_torch.data.tokenizer import WordTokenizer

import _torch_port_dp as dpcase
from _torch_port_util import TINY, example_batch, tiny_pair

torch.set_num_threads(2)
VOCAB = 50


def _word_tokenizer(cls):
    vocab = {t: i for i, t in enumerate(["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"])}
    for i in range(VOCAB - 7):
        vocab[f"w{i}"] = len(vocab)
    return cls(vocab)


def _loader():
    """3 batches of 4 anchors + 4 aux views; the last one's fourth study is
    padding (rank 1 holds it)."""
    rng = np.random.default_rng(11)
    batches = []
    for i in range(3):
        b = example_batch(rng, 4, 4, 32, 16, VOCAB)
        b["_image_ids"] = [f"s{i}_{j}" for j in range(4)]
        b["_gts"] = [f"gt {i} {j}" for j in range(4)]
        if i == 2:
            b["valid"][[3, 7]] = False
            b["_image_ids"][3] = ""
        batches.append(b)
    return batches


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX references on a dp=2 mesh, and one 2-rank spawn of the port."""
    jm, v, tm, batch = tiny_pair(VOCAB)
    state = TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=None)
    mesh = jmesh.create_mesh(jmesh.MeshSpec(dp=2))
    jtok = _word_tokenizer(JTok)
    gen = make_generate_step(jm, jtok, JDecodeConfig(beam_size=3), 16, with_indication=True,
                             serving=True, mesh=mesh)
    want = {"tokens": np.asarray(gen(state, jmesh.shard_batch(batch, mesh))),
            "report_server": JServer(jm, jtok, state, JDecodeConfig(beam_size=3), 16,
                                     mesh=mesh).serve(_loader(), with_indication=True)}
    recs, stats = JContinuous(jm, jtok, state, max_seq_len=16, slots=4, beam_size=3,
                              seg_steps=4, dispatch_segs=2, pack_batches=2,
                              mesh=mesh).serve(_loader())
    want["continuous"] = (recs, stats["reports"])
    inp = {"dims": TINY, "vocab": VOCAB, "sd": tm.state_dict(),
           "tokenizer": _word_tokenizer(WordTokenizer), "batch": batch, "loader": _loader()}
    path = str(tmp_path_factory.mktemp("dp_serve") / "inputs.pt")
    torch.save(inp, path)
    return want, dpcase.spawn_case(dpcase.serving, path, timeout_s=200)


def test_generate_step_over_dp_emits_jax_dp_tokens(served):
    want, ranks = served
    got = np.concatenate([r["tokens"] for r in ranks])
    assert got.shape == want["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(got, want["tokens"])


def test_report_server_over_dp_serves_jax_dp_records(served):
    want, ranks = served
    assert len(want["report_server"]) == 11
    assert len({r["report"] for r in want["report_server"]}) > 1
    for r in ranks:
        assert r["report_server"] == want["report_server"]


def test_continuous_engine_over_dp_serves_jax_dp_reports(served):
    want, ranks = served
    recs, n = want["continuous"]
    assert n == 11
    for r in ranks:
        got, got_n = r["continuous"]
        assert got == recs and got_n == n
    # a study's report does not depend on its slot: both engines agree
    assert {r["id"]: r["report"] for r in recs} == {
        r["id"]: r["report"] for r in want["report_server"]}
