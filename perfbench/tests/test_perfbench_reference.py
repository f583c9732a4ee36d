"""The plain reference against the program at a small size in float32: the
same weights give the same logits, the served tokens are the reference's, and
the reference's beam search serves them too."""

import pytest
import torch

from pb import refmodel, serving
from pb.common import load_module
from small import run_small, small


@pytest.mark.parametrize("kind", ["r2gen", "cmn"])
def test_logits_match_the_program(kind):
    from evoke_tpu_torch.train.steps import maybe_normalize_images

    cell = "r2gen224.batch.lenmix" if kind == "r2gen" else "cmn224.batch.full100"
    _, cfg, traffic = small(cell)
    model = serving.build_model(cfg, 7, "cpu")
    gen = load_module("generators", traffic["generator"]).make(traffic, cfg, 7)
    P = {k: v.float() for k, v in serving.make_weights(
        refmodel.param_spec(cfg["model"]), 7, "cpu", torch.float32).items()}
    ref = refmodel.Ref(P, cfg["model"])
    rows = [0, 1, 2, 3]
    raw = {k: torch.as_tensor(v) for k, v in gen.study_inputs(0, rows).items()}
    ids = torch.randint(5, cfg["model"]["vocab_size"] - 2, (len(rows), 9),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        b = maybe_normalize_images(raw)
        hid = model.encode(b["images"], b["pids"], b["valid"], len(rows), b["inc_ids"],
                           b["inc_mask"])
        want = ref.encode(raw["images"], raw["pids"], raw["valid"], len(rows),
                          raw["inc_ids"], raw["inc_mask"])
        assert torch.allclose(hid, want, rtol=1e-4, atol=1e-4)
        att = hid[:, 1:]
        mask = torch.ones(att.shape[:2], dtype=torch.int32)
        got = model.text_decoder(att, mask, ids, torch.ones_like(ids))
        lg = ref.decode_logits(ref.decoder_memory(want[:, 1:]), ids)
        assert torch.allclose(got, torch.log_softmax(lg, -1), atol=1e-4)


@pytest.mark.parametrize("cell", ["r2gen224.batch.lenmix", "cmn224.batch.full100",
                                  "r2gen224.continuous.lenmix"])
def test_served_tokens_are_the_references(cell):
    ctx, out = run_small(cell, seconds=0.5)
    assert out.correct, out.checks
    assert ctx.extra["gaps"]["served_gap"] < 1e-4


@pytest.mark.parametrize("cell", ["r2gen224.batch.lenmix", "cmn224.batch.full100",
                                  "r2gen224.continuous.lenmix"])
def test_the_references_beam_search_serves_the_programs_tokens(cell):
    """The search the control decodes with is the servers' search: at float32
    the reference's own beam serves what the program served."""
    ctx, _ = run_small(cell, seconds=0.5)
    m = ctx.cfg["model"]
    P = {k: v.float() for k, v in serving.make_weights(
        refmodel.param_spec(m), ctx.seed, "cpu", torch.float32).items()}
    ref = refmodel.Ref(P, m)
    tok = serving.SpelledIds(m["vocab_size"])
    studies = ctx.window.studies[:6]
    assert studies
    with torch.no_grad():
        for s in studies:
            inputs = {k: torch.as_tensor(v) for k, v in
                      ctx.extra["gen"].study_inputs(s.pool, [s.row]).items()}
            n = len(s.tokens) - (1 if s.target is not None else 0)
            banned = [tok.unk_id] + ([tok.eos_id] if s.target is not None else [])
            got = refmodel.beam_decode(ref, refmodel.study_memory(ref, inputs, True), n,
                                       ctx.cfg["decode"]["beam_size"], tok.bos_id, banned)
            assert list(got) == list(s.tokens[:n]), s.id
