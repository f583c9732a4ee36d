"""Port parity: ReportServer (serve.py) gives the JAX ReportServer's records
for the tiny flagship at float32, and refuses a batch whose studies exceed the
grouped fusion attention's partner bound."""

import numpy as np
import pytest
import torch

from evoke_tpu.core.config import DecodeConfig as JDecodeConfig
from evoke_tpu.data.tokenizer import WordTokenizer as JTok
from evoke_tpu.serve import ReportServer as JServer
from evoke_tpu.train.steps import TrainState
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.data.tokenizer import WordTokenizer
from evoke_tpu_torch.serve import ReportServer

from _torch_port_util import Tok, tiny_pair

torch.set_num_threads(1)
VOCAB = 50


def _jax_state(v):
    return TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=None)


def _word_tokenizer(cls):
    vocab = {t: i for i, t in enumerate(["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"])}
    for i in range(VOCAB - 7):
        vocab[f"w{i}"] = len(vocab)
    return cls(vocab)


def test_report_server_records_match_jax():
    """ReportServer gives the JAX server's records. Both serve with 8 cache
    phases; the port's serving policy takes ancestor caches + the fused tail
    (plain versions on the CPU), JAX's off-TPU policy reorder + unfused: at
    float32 the attended sets and candidates are identical."""
    jm, v, tm, batch = tiny_pair(VOCAB)

    def loader():
        for i in range(2):
            yield {**batch, "_image_ids": [f"s{i}_0", f"s{i}_1"], "_gts": ["a", "b"]}

    jtok, ttok = _word_tokenizer(JTok), _word_tokenizer(WordTokenizer)
    assert jtok.vocab == ttok.vocab and ttok.get_vocab_size() == VOCAB
    want = JServer(jm, jtok, _jax_state(v), JDecodeConfig(beam_size=3), 16).serve(
        list(loader()), with_indication=True)
    srv = ReportServer(tm, ttok, DecodeConfig(beam_size=3), 16, device="cpu")
    got = srv.serve(list(loader()), with_indication=True)
    assert got == want
    assert srv.stats["reports"] == 4 and srv.stats["batches"] == 2
    assert srv.stats["reports_per_s"] > 0 and srv.stats["batch_latency_p50_s"] > 0


def test_report_server_refuses_batches_beyond_the_partner_bound():
    class M:
        fusion_max_partners = 1
        decoder_kind = "r2gen"

    srv = ReportServer(M(), Tok(VOCAB), DecodeConfig(beam_size=3), 16, device="cpu")
    bad = {"ids": np.zeros((1, 4), np.int32), "pids": np.zeros(3, np.int32),
           "valid": np.ones(3, bool), "images": np.zeros((3, 8, 8, 3), np.float32),
           "_image_ids": ["x"]}
    with pytest.raises(ValueError, match="fusion_max_partners"):
        srv.serve([bad])
