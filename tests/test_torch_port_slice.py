"""Port parity for the whole serving slice: beam-3 report generation through
make_generate_step and ReportServer, on the tiny flagship at float32, must
give token-identical sequences to the JAX package in both cache modes
(ReportServer: tests/test_torch_port_serve.py):

- reorder (eval policy: serving=False, one cache phase, unfused tail);
- ancestor (serving policy: 8 cache phases, lineage attention + fused tail;
  the JAX side forced onto its Pallas kernels in interpret mode).

Plus the whole encoder side (encode_for_decode, rtol 1e-3 for the ResNet
depth), generate_stream's ordering and the tokenizer and config copies (the
other decoding modes: tests/test_torch_port_decoding_modes.py)."""

import numpy as np
import pytest
import torch

from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.data.tokenizer import WordTokenizer as JTok
from evoke_tpu.train.steps import TrainState, make_generate_step as j_make
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.serve import generate_stream
from evoke_tpu_torch.train.steps import make_generate_step

from _torch_port_util import Tok, tiny_pair, torch_batch

torch.set_num_threads(1)
VOCAB = 50


def _jax_state(v):
    return TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=None)


@pytest.mark.parametrize("mode,suppress_unk", [("reorder", False), ("ancestor", True)])
def test_generate_matches_jax(monkeypatch, mode, suppress_unk):
    jm, v, tm, batch = tiny_pair(VOCAB)
    serving = mode == "ancestor"
    if serving:
        monkeypatch.setenv("EVOKE_LINEAGE_KERNEL", "pallas")
        monkeypatch.setenv("EVOKE_LOGIT_TOPK", "fused")
    jcfg = JDecodeConfig(beam_size=3, beam_kv=mode, suppress_unk=suppress_unk)
    want = np.asarray(j_make(jm, Tok(VOCAB), jcfg, 16, with_indication=True,
                             serving=serving, all_samples=True)(_jax_state(v), batch))
    gen = make_generate_step(tm, Tok(VOCAB), DecodeConfig(beam_size=3, beam_kv=mode,
                                                           suppress_unk=suppress_unk),
                             16, with_indication=True, serving=serving, all_samples=True,
                             device="cpu")
    assert gen.ancestor_kv == serving and gen.fused_topk == serving
    assert gen.schedule == ((2, 4, 6, 8, 10, 12, 14, 16) if serving else (16,))
    got = gen(torch_batch(batch)).numpy()
    assert got.shape == (2, 3, 16)
    np.testing.assert_array_equal(want, got)
    # the sharpened head must make the comparison non-trivial
    assert len(np.unique(got)) > 3


@pytest.mark.parametrize("with_indication", [True, False])
def test_encode_for_decode(with_indication):
    """The whole encoder side of the tiny FinetuneModel, with and without the
    indication (BertCrossLayer vs BertLayer)."""
    jm, v, tm, batch = tiny_pair()
    inc = ([batch["inc_ids"], batch["inc_mask"]]) if with_indication else []
    je, jam = jm.apply(v, batch["images"], batch["pids"], batch["valid"], 2, *inc,
                       method=jm.encode_for_decode)
    tb = torch_batch(batch)
    tinc = [tb["inc_ids"], tb["inc_mask"]] if with_indication else []
    with torch.no_grad():
        te, tam = tm.encode_for_decode(tb["images"], tb["pids"], tb["valid"], 2, *tinc)
    np.testing.assert_array_equal(np.asarray(jam), tam.numpy())
    np.testing.assert_allclose(np.asarray(je), te.numpy(), rtol=1e-3, atol=1e-4)


def test_generate_stream_order_and_depth():
    calls = []

    def fake_gen(dev):
        calls.append(dev["n"])
        return torch.full((2, 3), dev["n"])

    batches = [({"n": i}, {"_idx": i}) for i in range(7)]
    for depth in (1, 2, 4, 10):
        calls.clear()
        out = list(generate_stream(fake_gen, iter(batches), depth=depth))
        assert [h["_idx"] for h, _ in out] == list(range(7))
        assert [int(s[0, 0]) for _, s in out] == list(range(7))
        assert calls == list(range(7))


def test_config_and_tokenizer_copies_agree(tmp_path):
    import dataclasses

    jd = dataclasses.asdict(JDecodeConfig())
    td = dataclasses.asdict(DecodeConfig())
    assert jd == td
    from evoke_tpu.core.config import ModelConfig as JModelConfig
    from evoke_tpu_torch.core.config import ModelConfig

    jm = dataclasses.asdict(JModelConfig())
    for key, val in dataclasses.asdict(ModelConfig()).items():
        assert jm[key] == val, key
    corpus = ["No acute disease.", "Heart size is normal; lungs are clear.", "no effusion"]
    jt, tt = JTok.train(corpus), WordTokenizer.train(corpus)
    assert jt.vocab == tt.vocab
    text = "heart is clear [UNK] unknownword ."
    assert jt.encode(text) == tt.encode(text)
    assert jt.decode(jt.encode(text)) == tt.decode(tt.encode(text))
    jt.save(str(tmp_path / "tok.json"))
    assert WordTokenizer.from_file(str(tmp_path / "tok.json")).vocab == jt.vocab
