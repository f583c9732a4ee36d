"""Small sizes of the benchmark's configurations and mixes, for runs on the CPU."""

import copy

from pb.common import load_json

SMALL_MODEL = dict(vocab_size=60, output_dim=64, encoder_hidden_size=32, encoder_num_layers=1,
                   encoder_num_heads=2, encoder_intermediate_size=64, d_model=32, d_ff=64,
                   num_heads=2, num_layers=2, rm_num_slots=3, rm_d_model=32, rm_num_heads=2,
                   fusion_num_heads=2, fusion_intermediate_size=64, proj_num_heads=2,
                   max_seq_len=16, cmm_size=40, cmm_dim=32, cmn_topk=4)


def small(cell_name):
    """(cell, config, traffic) of ``cell_name`` at a size the CPU runs in seconds:
    64 px images, 8 studies a batch, reports up to 16 tokens."""
    cell = load_json("cells", cell_name)
    cfg = copy.deepcopy(load_json("configs", cell["config"]))
    cfg["model"].update(SMALL_MODEL)
    cfg["image_size"] = 64
    cfg["dtype"] = "float32"
    traffic = copy.deepcopy(load_json("traffic", cell["traffic"]))
    traffic.update(studies_per_batch=8, pool_batches=3, trace_batches=2,
                   check_studies=6, check_min_tokens=20,
                   indication_words={"median": 5, "sigma": 0.5, "clip": [2, 12]})
    if traffic.get("report_words"):
        traffic["report_words"] = {"median": 8, "sigma": 0.45, "clip": [3, 14]}
    cell = copy.deepcopy(cell)
    cell["warm_seconds"] = 0.2
    if "slots" in cell["engine_settings"]:
        cell["engine_settings"].update(slots=8, seg_steps=4, pack_batches=2)
    return cell, cfg, traffic


def run_small(cell_name, seed=2 ** 31 + 17, seconds=1.0, trace=False, patch=None):
    """One run of ``cell_name`` at its small size on the CPU: (context, outcome);
    ``patch(ctx)`` may change the context first."""
    import time

    import torch

    from pb import harness

    cell, cfg, traffic = small(cell_name)
    ctx = harness.make_context(cell_name, seed, seconds, trace, torch.device("cpu"),
                               time.perf_counter(), cell=cell, cfg=cfg, traffic=traffic)
    if patch is not None:
        patch(ctx)
    return ctx, harness.run_cell(ctx)
