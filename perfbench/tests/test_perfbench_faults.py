"""The fault a serving cell can have, planted underneath the timed path,
turns ``correct`` false: a served token altered where it is produced."""

import pytest
import torch

from small import run_small

UNK = 4


@pytest.mark.parametrize("cell", ["r2gen224.batch.lenmix", "cmn224.batch.full100"])
def test_batch_engine_token_altered(cell, monkeypatch):
    from evoke_tpu_torch.decode import beam

    stage2 = beam.BeamLoop._stage2

    def altered(self, vals, tok_cand, lse, t):
        scores, beam_idx, tok_idx = stage2(self, vals, tok_cand, lse, t)
        if t == 1:
            tok_idx = torch.where(tok_idx == self.eos_id, tok_idx, torch.full_like(tok_idx, UNK))
        return scores, beam_idx, tok_idx

    monkeypatch.setattr(beam.BeamLoop, "_stage2", altered)
    _, out = run_small(cell, seconds=0.5)
    assert not out.correct


def test_continuous_engine_token_altered(monkeypatch):
    from evoke_tpu_torch.models import rm_decoder

    fused = rm_decoder.fused_logit_topk

    def altered(*a, **k):
        vals, idx, lse = fused(*a, **k)
        return vals, torch.where(torch.rand(idx.shape) < 0.2, UNK, idx), lse

    monkeypatch.setattr(rm_decoder, "fused_logit_topk", altered)
    _, out = run_small("r2gen224.continuous.lenmix", seconds=0.5)
    assert not out.correct
