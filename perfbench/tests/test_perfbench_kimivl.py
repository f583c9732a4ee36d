"""The ``mla_moe`` cell (``kimivl224.batch.lenmix256``) at a small size on the
CPU: a run through ``engines/batch_serve_lm.py`` is correct against
``pb/ref_mla_moe.py``, reads its new metrics in a traced run, and the float8
control fails the limit that the float32 program passes."""

import copy

import pytest
import torch

from pb import harness, ref_mla_moe, shapes_mla_moe
from pb.common import load_json

CELL = "kimivl224.batch.lenmix256"
SMALL_LM = dict(vocab_size=4000, hidden_size=32, intermediate_size=64, moe_intermediate_size=16,
                num_hidden_layers=3, num_attention_heads=2, num_key_value_heads=2,
                n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1, kv_lora_rank=16,
                qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8,
                max_position_embeddings=256)
SMALL_ENC = dict(vocab_size=3999, output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
                 encoder_num_heads=2, encoder_intermediate_size=64, fusion_num_heads=2,
                 fusion_intermediate_size=64, proj_num_heads=2, d_model=32, max_seq_len=16)


def small():
    cell = copy.deepcopy(load_json("cells", CELL))
    cfg = copy.deepcopy(load_json("configs", cell["config"]))
    cfg.update(SMALL_LM)
    cfg["model"].update(SMALL_ENC)
    cfg.update(image_size=64, dtype="float32")
    traffic = copy.deepcopy(load_json("traffic", cell["traffic"]))
    traffic.update(studies_per_batch=8, pool_batches=3, trace_batches=2, check_studies=6,
                   check_min_tokens=20,
                   indication_words={"median": 5, "sigma": 0.5, "clip": [2, 12]},
                   report_words={"median": 8, "sigma": 0.45, "clip": [3, 14]})
    cell["warm_seconds"] = 0.2
    return cell, cfg, traffic


def run(trace=False, control=False, seconds=0.5):
    import time

    cell, cfg, traffic = small()
    ctx = harness.make_context(CELL, 2 ** 31 + 17, seconds, trace, torch.device("cpu"),
                               time.perf_counter(), cell=cell, cfg=cfg, traffic=traffic)
    if control:
        ctx.extra["control"] = True
        ctx.cell["limits"]["served_gap"] = 0.01
    return ctx, harness.run_cell(ctx)


def test_a_traced_run_is_correct_and_reads_its_metrics():
    ctx, out = run(trace=True)
    assert out.correct, out.checks
    assert ctx.extra["gaps"]["served_gap"] < 1e-3
    line = harness.result_line(harness.load_benchmark(), ctx, out, "cpu", 1)
    got = line["metrics"]
    for name in ("decode_mfu.mla_moe", "device_idle_share.decode", "queue_wait_ms.batch"):
        assert name in got, name
    # no device trace off the card: the kernel metrics read nothing
    assert "moe_expert_roofline" not in got and "fused_logit_topk_roofline" not in got
    led = ctx.extra["expert_ledger"]
    assert led["calls"][0] == 2 and led["calls"][1] >= 2 * 3     # 2 batches, >= 3 steps each
    assert led["rows"][1].sum() == led["calls"][1] * 8 * 3 * 2 * 2     # rows x top-2 x 2 layers


def test_the_float8_control_fails_the_limit_the_program_passes():
    ctx, out = run(control=True)
    assert out.correct, out.checks
    control = {name: (value, ok) for name, value, _, ok in ctx.extra["control_checks"]}
    assert not control["served_gap"][1], control


def test_operation_counts():
    _, cfg, _ = small()
    c = ref_mla_moe.lm_config(cfg)
    # a decode step: the head plus every layer's active products and attention
    one = shapes_mla_moe.decode_step_flops(cfg, 10)
    assert one > 2 * 32 * 4000
    assert shapes_mla_moe.expert_flops(c, 5) == 5 * 3 * 2 * 32 * 16
    assert shapes_mla_moe.expert_bytes(c, 2, 5) == 2 * (2 * 3 * 32 * 16 + 5 * 2 * 32)
    with pytest.raises(KeyError):
        ref_mla_moe.lm_config({})
