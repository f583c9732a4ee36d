"""Port parity: ViT-B/32 (models/vit.py), its wiring into FinetuneModel, the
attention heatmaps (evals/heatmaps.py) and the opt-in record of attention
probabilities, against the JAX package on the CPU at float32.

- ViTExtractor at toy widths: patch tokens and CLS at atol 1e-5 / rtol 1e-4
  (tests/test_torch_port_layers.py's TOL); at ViT-B/32's own widths inside
  the tiny FinetuneModel, ``encode_for_decode`` at rtol 1e-3 / atol 1e-4 (the
  ResNet side's bound in tests/test_torch_port_slice.py: 12 blocks of 768).
- The colour maths on the same attention weights: the blended heatmap
  bit-equal, the PNG's pixels equal to those JAX's writer (PIL) stores.
- ``render_generation_heatmaps`` on the tiny flagship with the same
  sequences: the same files, pixels within one level of 255 (the attention
  maps agree to float32 rounding; a level boundary may fall between them).
- The record is off by default and off again after ``recorded_attention``.
- The serve CLI with diverse beam search (beam 4, group 2) writes JAX's
  serve_prediction.csv.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from evoke_tpu.evals import heatmaps as jheat
from evoke_tpu.models.vit import ViTExtractor as JViT
from evoke_tpu.train.steps import TrainState
from evoke_tpu_torch.evals import heatmaps as theat
from evoke_tpu_torch.models.vit import ViTExtractor as TViT
from evoke_tpu_torch.params import load_flax_variables

from _torch_port_util import TINY, example_batch, tiny_pair, to_np, torch_batch

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("image_size", [24, 40])
def test_vit_matches_jax(image_size):
    """Toy widths (patch 8, width 16, 2 blocks): 9 and 25 patches, so
    ``pos_embed`` (26 rows) is sliced to 10 rows, then used whole."""
    kw = dict(patch_size=8, width=16, num_layers=2, num_heads=2, mlp_dim=32, d_vf=24,
              max_patches=25)
    rng = np.random.default_rng(image_size)
    img = rng.normal(size=(3, image_size, image_size, 3)).astype(np.float32)
    jv = JViT(**kw)
    v = to_np(jax.jit(jv.init)(jax.random.key(0), img))
    assert v["params"]["cls"].shape == (1, 1, 16) and v["params"]["pos_embed"].shape == (
        1, 26, 16)
    tv = TViT(**kw)
    load_flax_variables(tv, v)
    jp, jc = jv.apply(v, img)
    with torch.no_grad():
        tp, tc = tv(torch.as_tensor(img))
    assert tuple(tp.shape) == (3, (image_size // 8) ** 2, 24) and tuple(tc.shape) == (3, 24)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_finetune_vit_encode_matches_jax():
    """visual_encoder='vit_b32' (ViT-B/32 at its widths, 64 px: 4 patches)
    with the R2Gen decoder: the decoder's encoder input."""
    import copy

    from evoke_tpu.models.finetune import FinetuneModel as JModel
    from evoke_tpu_torch.models.finetune import FinetuneModel as TModel

    _, v0, _, _ = tiny_pair()
    rng = np.random.default_rng(4)
    batch = example_batch(rng, 2, 2, 64, 16, 50)
    vit = JViT(d_vf=2048)
    vv = to_np(jax.jit(vit.init)(jax.random.key(1), batch["images"][:1]))
    v = copy.deepcopy(v0)
    v["params"]["visual_extractor"] = vv["params"]
    v["batch_stats"].pop("visual_extractor", None)
    jm = JModel(vocab_size=50, drop_prob_lm=0.5, visual_encoder="vit_b32", **TINY)
    tm = TModel(vocab_size=50, visual_encoder="vit_b32", **TINY).eval()
    load_flax_variables(tm, v)
    args = [batch["images"], batch["pids"], batch["valid"], 2, batch["inc_ids"],
            batch["inc_mask"]]
    je, _ = jm.apply(v, *args, method=jm.encode_for_decode)
    tb = torch_batch(batch)
    with torch.no_grad():
        te, _ = tm.encode_for_decode(tb["images"], tb["pids"], tb["valid"], 2,
                                     tb["inc_ids"], tb["inc_mask"])
    assert te.shape == (2, 4, TINY["d_model"])
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-3, atol=1e-4)


def test_colour_maths_and_png_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    image = rng.normal(size=(40, 40, 3)).astype(np.float32)
    weights = rng.random(16).astype(np.float32)
    want = jheat.token_heatmap(image, weights)
    got = theat.token_heatmap(image, weights)
    np.testing.assert_array_equal(got, want)
    jheat.save_png(want, str(tmp_path / "j.png"))
    theat.save_png(got, str(tmp_path / "t.png"))
    px = np.asarray(Image.open(tmp_path / "t.png"))
    assert px.dtype == np.uint8 and px.shape == (40, 40, 3)
    np.testing.assert_array_equal(px, np.asarray(Image.open(tmp_path / "j.png")))
    with pytest.raises(ValueError, match="square"):
        theat.token_heatmap(image, weights[:15])


class _WordTok:
    bos_id, eos_id, pad_id = 48, 49, 0

    def decode_batch(self, ids):
        return [" ".join(f"w{i}" for i in row) for row in ids]


def test_render_generation_heatmaps_equals_jax(tmp_path):
    """The tiny flagship at 64 px (a 2 x 2 patch grid), two studies, the
    same generated ids on both sides (one ends early at EOS)."""
    jm, v, tm, _ = tiny_pair()
    rng = np.random.default_rng(8)
    batch = example_batch(rng, 2, 2, 64, 16, 50)
    seqs = rng.integers(1, 48, size=(2, 16)).astype(np.int32)
    seqs[1, 6] = _WordTok.eos_id
    seqs[1, 7:] = 0
    state = TrainState(step=0, params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=None)
    ids = ["s0", "s1"]
    want = jheat.render_generation_heatmaps(jm, state, batch, seqs, _WordTok(),
                                            str(tmp_path / "j"), 2, study_ids=ids,
                                            with_indication=True)
    mods = theat.cross_attention_modules(tm)
    assert all(m.record is None for m in mods)
    got = theat.render_generation_heatmaps(tm, torch_batch(batch), seqs, _WordTok(),
                                           str(tmp_path / "t"), 2, study_ids=ids,
                                           with_indication=True)
    assert all(m.record is None for m in mods)
    rel = lambda paths, root: [os.path.relpath(p, root) for p in paths]  # noqa: E731
    assert rel(got, tmp_path / "t") == rel(want, tmp_path / "j")
    assert len(got) == 2 * (16 + 6)
    for g, w in zip(got, want):
        a = np.asarray(Image.open(g), np.int16)
        b = np.asarray(Image.open(w), np.int16)
        assert a.shape == b.shape == (64, 64, 3)
        assert np.abs(a - b).max() <= 1, g


def test_recorded_attention_keeps_every_call():
    from evoke_tpu_torch.models.layers import MultiHeadAttention
    from evoke_tpu_torch.params import init_params_

    mha = init_params_(MultiHeadAttention(2, 8)).eval()
    x = torch.randn(3, 5, 8)
    with theat.recorded_attention([mha]) as rec:
        mha(x, x, x)
        mha(x, x, x)
    assert mha.record is None and len(rec[0]) == 2 and rec[0][0].shape == (3, 2, 5, 5)
    torch.testing.assert_close(rec[0][0].sum(-1), torch.ones(3, 2, 5))


CLI_TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.d_model", "32",
    "--model.d_ff", "64", "--model.num_heads", "2", "--model.num_layers", "1",
    "--model.rm_num_slots", "2", "--model.rm_d_model", "32",
    "--model.fusion_num_heads", "2", "--model.fusion_intermediate_size", "64",
    "--model.image_size", "32", "--data.max_seq_len", "16",
    "--data.batch_size", "2", "--data.num_workers", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
]


def test_serve_cli_decode_settings_match_jax_cli(tmp_path):
    """The decode settings reach the serve CLI as they reach JAX's: the same
    float32 weights (the JAX CLI's seeded init, converted), the same
    serve_prediction.csv rows."""
    import csv

    from evoke_tpu import cli as jcli
    from evoke_tpu.core import config as jconfig
    from evoke_tpu.data import datasets as jdatasets
    from evoke_tpu.data import synthetic as jsynthetic
    from evoke_tpu.data import tokenizer as jtokenizer
    from evoke_tpu_torch import cli as tcli
    from evoke_tpu_torch.core import checkpoint as tcheckpoint
    from evoke_tpu_torch.params import flax_to_state_dict

    root = str(tmp_path)
    ann = jsynthetic.write_synthetic_dataset(root, n_train=4, n_val=2, n_test=5,
                                             image_size=32, seed=1)
    common = ["--data.ann_path", ann, "--data.image_dir", root,
              "--data.tokenizer_dir", os.path.join(root, "tok"),
              "--trainer.result_dir", os.path.join(root, "results")] + CLI_TINY + [
                  "--decode.beam_size", "4", "--decode.group_size", "2"]
    assert jcli.main(["serve", "--trainer.version", "jax"] + common) == 0
    cfg = jconfig.load_config(None, overrides={"trainer.task": "serve"}, argv=common)
    tok = jtokenizer.build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name, ann_path=ann)
    model = jcli.build_model(cfg, tok.get_vocab_size(), "finetune")
    loaders = jcli.build_loaders(cfg, tok, jdatasets.load_annotation(ann), "serve")
    state, _ = jcli.init_finetune_state(cfg, model, loaders)
    weights = os.path.join(root, "weights.pt")
    tcheckpoint.save_state_dict(flax_to_state_dict(
        {"params": state.params, "batch_stats": state.batch_stats}), weights)
    assert tcli.main(["serve", "--trainer.version", "torch", "--trainer.load", weights,
                      "--device", "cpu"] + common) == 0
    rows = {}
    for side in ("jax", "torch"):
        with open(os.path.join(root, "results", "mimic_cxr", "serve", side,
                               "serve_prediction.csv"), newline="") as f:
            rows[side] = list(csv.reader(f))
    assert len(rows["torch"]) == 6 and rows["torch"] == rows["jax"]
