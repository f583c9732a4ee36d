"""Command-line entry point of the port: ``python -m evoke_tpu_torch.cli <task> [--key value ...]``.

The task names, config keys, result-dir layout (results/{data}/{task}/{version})
and artifacts follow ``python -m evoke_tpu.cli``. ``--config file.yaml``
reads a YAML config; ``--device cuda|cpu`` (default cuda) picks the device:
without CUDA the run raises unless ``--device cpu`` is given, which runs the
kernels' plain PyTorch versions.

Ported:

- ``finetune``: stage-2 training (train steps over the indication loader,
  then the no-indication loader; the optax-exact RAdam / AMSGrad chain in two
  groups), then beam decode of val and test on the eval path with their
  metrics and ``{split}_prediction.csv`` columns, every epoch; checkpoints
  under ``{result_dir}/checkpoint/`` (``current`` every ``save_period``
  epochs, ``best`` on monitor improvement), ``--trainer.resume auto|current|
  best`` and ``--trainer.load <slot dir or state dict file>``;
- ``test``: beam decode of the test split on the eval path, the metrics (NLG
  always; CheXbert on the device when ``--metrics.chexbert_checkpoint`` is
  set; the other CE metrics when their packages and checkpoints are there),
  ``test_prediction.csv`` with the metric rows first, ``test.log``,
  ``metrics.jsonl`` and ``config.json``;
- ``score``: the NLG metrics of a predictions file (``--data.ann_path``: a
  ``test_prediction.csv`` or JSON ``{"gts": {id: text}, "res": {id: text}}``)
  as JSON on stdout; runs on the host;
- ``serve`` (streaming beam decode over the test split,
  ``serve_prediction.csv`` and a JSON throughput summary) with either engine:
  ``--decode.engine batch`` (the default: pipelined batches) or
  ``continuous`` (slots refilled mid-stream, ``decode/continuous.py``).

``pretrain`` and ``retrieve`` raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, List, Optional

TASKS = ("pretrain", "finetune", "test", "retrieve", "score", "serve")
_NOT_PORTED = {"pretrain": "A11", "retrieve": "A11"}


def build_model(cfg, vocab_size: int, device):
    """The finetune model of ``evoke_tpu/cli.py`` build_model, on ``device``."""
    import torch

    from evoke_tpu_torch.models.finetune import FinetuneModel

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    m = cfg.model
    partners = None if m.fusion_max_partners is None else int(m.fusion_max_partners)
    with torch.device(device):
        return FinetuneModel(
            vocab_size=vocab_size, d_vf=m.d_vf, output_dim=m.output_dim,
            encoder_hidden_size=m.encoder_hidden_size,
            encoder_num_layers=m.encoder_num_hidden_layers,
            encoder_num_heads=m.encoder_num_heads,
            encoder_intermediate_size=m.encoder_intermediate_size,
            proj_num_heads=m.proj_num_heads, fusion_wide_qkv=m.fusion_wide_qkv,
            fusion_max_partners=partners, is_multiview_learning=m.is_multiview_learning,
            fusion_num_heads=m.fusion_num_heads,
            fusion_intermediate_size=m.fusion_intermediate_size,
            sk_fusion_num_layers=m.sk_fusion_num_layers, d_model=m.d_model, d_ff=m.d_ff,
            num_heads=m.num_heads, num_layers=m.num_layers, dropout=m.dropout,
            drop_prob_lm=m.drop_prob_lm, rm_num_slots=m.rm_num_slots,
            rm_num_heads=m.rm_num_heads, rm_d_model=m.rm_d_model,
            max_seq_len=cfg.data.max_seq_len, remat_visual=m.remat_visual, dtype=dtype)


def build_loaders(cfg, tokenizer, ann, split: str = "test", train: bool = False):
    """One split's (with-indication, without-indication) loaders, as
    ``evoke_tpu/cli.py`` build_loaders makes them for the finetune model
    (None where a stream is empty or indication is off); ``train``: the
    training transform and a shuffled order."""
    from evoke_tpu_torch.data.batching import MultiviewBatcher
    from evoke_tpu_torch.data.datasets import parse_finetune
    from evoke_tpu_torch.data.transforms import make_transform

    common = dict(n_anchor=cfg.data.batch_size, max_seq_len=cfg.data.max_seq_len,
                  image_dir=cfg.data.image_dir, num_workers=cfg.data.num_workers)
    tf = make_transform(cfg.model.image_size, train, output_uint8=cfg.data.images_uint8)
    has_ind, no_ind = parse_finetune(ann, split)

    def mk(exs, with_ind):
        if not exs:
            return None
        return MultiviewBatcher(exs, tokenizer, tf, shuffle=train, with_indication=with_ind,
                                text_field="report", add_bos_eos=True,
                                multiview=cfg.model.is_multiview_learning, **common)

    inc = mk(has_ind, True) if cfg.model.is_add_indication else None
    no = mk(no_ind + ([] if cfg.model.is_add_indication else has_ind), False)
    return inc, no


def _pop_option(argv: List[str], name: str):
    """Remove ``--name value`` / ``--name=value`` from argv; returns the value."""
    for i, tok in enumerate(argv):
        if tok == name:
            if i + 1 >= len(argv):
                raise ValueError(f"{name} needs a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
        if tok.startswith(name + "="):
            del argv[i]
            return tok.split("=", 1)[1]
    return None


def metrics_fn_for(cfg, device="cuda"):
    """NLG always; CE metrics only when their checkpoints/deps are available
    (CheXbert on ``device``)."""
    from evoke_tpu_torch.evals.composite import compute_all_scores

    def fn(gts: Dict[str, List[str]], res: Dict[str, List[str]]) -> Dict[str, float]:
        return compute_all_scores(gts, res, cfg.metrics, device)

    return fn


def _check_heatmaps(cfg) -> None:
    if cfg.trainer.plot_heatmaps > 0:
        raise NotImplementedError("trainer.plot_heatmaps > 0: attention heatmaps are "
                                  "ROADMAP A12b")


ENGINES = ("batch", "continuous")


def _check_serve_config(cfg) -> None:
    if cfg.decode.engine not in ENGINES:
        raise ValueError(f"decode.engine={cfg.decode.engine!r}: one of {ENGINES}")
    if cfg.decode.serve_dp:
        raise NotImplementedError(f"decode.serve_dp={cfg.decode.serve_dp}: multi-GPU "
                                  "serving is ROADMAP A13")
    _check_heatmaps(cfg)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("tasks: pretrain | finetune | test | retrieve | score | serve")
        return 0
    task = argv[0]
    if task not in TASKS:
        print(f"unknown task {task!r}; "
              f"tasks: pretrain | finetune | test | retrieve | score | serve", file=sys.stderr)
        return 2
    from evoke_tpu_torch.core.config import load_config
    from evoke_tpu_torch.core.device import resolve_device

    rest = argv[1:]
    yaml_path = _pop_option(rest, "--config")
    device = _pop_option(rest, "--device") or "cuda"
    # serve keeps its own task name (results/{data}/serve/{version})
    cfg = load_config(yaml_path, overrides={"trainer.task": task}, argv=rest)
    cfg.trainer.task = task
    if task in _NOT_PORTED:
        raise NotImplementedError(f"task {task!r} is not ported yet "
                                  f"(ROADMAP {_NOT_PORTED[task]}); ported: finetune, test, "
                                  "score, serve")
    if task == "score":
        return _score(cfg)
    if task == "serve":
        _check_serve_config(cfg)
    else:
        _check_heatmaps(cfg)
    device = resolve_device(device)

    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.data.tokenizer import build_tokenizer
    from evoke_tpu_torch.params import init_params_

    ann = load_annotation(cfg.data.ann_path)
    tokenizer = build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name,
                                ann_path=cfg.data.ann_path, model=cfg.data.tokenizer_model,
                                tokenizer_type=cfg.data.tokenizer_type)
    cfg.vocab_size = tokenizer.get_vocab_size()
    model = build_model(cfg, cfg.vocab_size, device)
    init_params_(model, cfg.trainer.seed)
    model.eval()
    if task == "finetune":
        return _finetune(cfg, model, tokenizer, ann, device)
    loaders = build_loaders(cfg, tokenizer, ann)
    if task == "test":
        from evoke_tpu_torch.train.trainer import Tester

        # Tester loads --trainer.load into the model (BaseTrainer._partial_load)
        Tester(cfg, model, tokenizer, eval_loaders={"test": loaders},
               metrics_fn=metrics_fn_for(cfg, device), device=device).test()
        return 0
    if cfg.trainer.load:
        from evoke_tpu_torch.core.checkpoint import partial_restore_from

        print(f"loaded weights: {partial_restore_from(cfg.trainer.load, model)}")
    return _serve(cfg, model, tokenizer, loaders, device)


def _finetune(cfg, model, tokenizer, ann, device) -> int:
    """Stage-2 training (``evoke_tpu/cli.py``'s finetune task): the model
    initialised from the seed, the optimizer over its parameters (the
    state of ``init_finetune_state``), FinetuneTrainer over the train loaders
    with val and test evaluated every epoch."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState
    from evoke_tpu_torch.train.trainer import FinetuneTrainer

    o = cfg.optim
    opt = build_optimizer(o.optim, "finetune", model, pt_lr=o.pt_lr, ft_lr=o.ft_lr,
                          weight_decay=o.weight_decay, grad_clip_value=o.grad_clip_value,
                          grad_accum_steps=o.grad_accum_steps)
    loaders = {split: build_loaders(cfg, tokenizer, ann, split, train=split == "train")
               for split in ("train", "val", "test")}
    trainer = FinetuneTrainer(cfg, model, tokenizer,
                              eval_loaders={"val": loaders["val"], "test": loaders["test"]},
                              state=TrainState(model, opt), train_loaders=loaders["train"],
                              metrics_fn=metrics_fn_for(cfg, device), device=device)
    trainer.train()
    return 0


def _serve(cfg, model, tokenizer, test_loaders, device) -> int:
    """Streaming inference over the test split: pipelined beam decode by the
    batch or the continuous engine, predictions CSV and a throughput summary
    (no metric scoring)."""
    records: List[Dict] = []
    stats: List[Dict[str, float]] = []
    inc, no = test_loaders
    if cfg.decode.engine == "continuous":
        from evoke_tpu_torch.decode.continuous import ContinuousServer

        d = cfg.decode
        server = ContinuousServer(
            model, tokenizer, max_seq_len=cfg.data.max_seq_len, slots=d.slots,
            beam_size=d.beam_size, seg_steps=d.seg_steps, dispatch_segs=d.dispatch_segs,
            pack_batches=d.pack_batches, suppress_unk=d.suppress_unk,
            length_penalty=d.length_penalty, beam_kv=d.beam_kv,
            kv_cache_dtype=d.kv_cache_dtype, device=device)
        for loader in (inc, no):
            if loader is None:
                continue
            recs, st = server.serve(loader, prefetch=cfg.data.prefetch)
            records.extend(recs)
            stats.append(st)
    else:
        from evoke_tpu_torch.serve import ReportServer

        server = ReportServer(model, tokenizer, cfg.decode, max_seq_len=cfg.data.max_seq_len,
                              device=device)
        for loader, with_ind in ((inc, True), (no, False)):
            if loader is None:
                continue
            records.extend(server.serve(loader, with_indication=with_ind))
            stats.append(dict(server.stats))
    os.makedirs(cfg.result_dir, exist_ok=True)
    out_path = os.path.join(cfg.result_dir, "serve_prediction.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["images_id", "generated_reports", "ground_truth"])
        for r in records:
            w.writerow([r["id"], r["report"], r.get("gt", "")])
    wall = sum(s["wall_s"] for s in stats)
    n = int(sum(s["reports"] for s in stats))
    print(json.dumps({"reports": n, "wall_s": round(wall, 3),
                      "reports_per_s": round(n / wall, 3) if wall else None,
                      "prediction_csv": out_path}))
    return 0


def _score(cfg) -> int:
    """Score a predictions file (``--data.ann_path``): JSON ``{gts, res}`` or a
    test_prediction.csv, whose metric rows (``__metric__*``, or the
    reference's rows with an empty ground truth) are dropped and whose last
    ``pred_*`` column (else ``generated_reports``) is scored."""
    from evoke_tpu_torch.evals.nlg import compute_nlg_scores

    path = cfg.data.ann_path
    if path.endswith(".csv"):
        from evoke_tpu_torch.core.loggers import read_csv

        columns, rows = read_csv(path)
        rows = [r for r in rows if not str(r["images_id"]).startswith("__metric__")
                and r["ground_truth"] is not None]
        pred_cols = [c for c in columns if c.startswith("pred_")]
        pred_col = pred_cols[-1] if pred_cols else "generated_reports"
        text = lambda v: "nan" if v is None else v       # pandas' str(NaN)
        gts = {r["images_id"]: [text(r["ground_truth"])] for r in rows}
        res = {r["images_id"]: [text(r[pred_col])] for r in rows}
    else:
        with open(path) as f:
            blob = json.load(f)
        gts = {k: [v] for k, v in blob["gts"].items()}
        res = {k: [v] for k, v in blob["res"].items()}
    print(json.dumps(compute_nlg_scores(gts, res), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
