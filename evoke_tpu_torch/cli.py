"""Command-line entry point of the port: ``python -m evoke_tpu_torch.cli <task> [--key value ...]``.

The task names, config keys, result-dir layout (results/{data}/{task}/{version})
and artifacts follow ``python -m evoke_tpu.cli``. ``--config file.yaml``
reads a YAML config; ``--device cuda|cpu`` (default cuda) picks the device:
without CUDA the run raises unless ``--device cpu`` is given, which runs the
kernels' plain PyTorch versions.

The tasks:

- ``pretrain``: stage-1 contrastive training (the multi-positive image
  loss, global and local image-text alignment; RAdam / AMSGrad in one group
  at ``pt_lr``), the eval step over val every epoch and over test every
  ``trainer.test_every`` epochs, the monitor on ``val_all_loss`` (min);
  checkpoints, ``--trainer.resume`` and ``--trainer.load`` as in finetune;
- ``retrieve``: stage-1 weights from ``--trainer.load`` (a partial load),
  every train, val and test study encoded on the eval path into a float16
  database of flattened token embeddings, an exact top-k search on the
  device (``retrieval/topk.py``), and ``<ann>_best_reports_keywords_{topk}.json``
  beside the annotation; ``--data.retrieve_db_ann_path`` /
  ``retrieve_db_image_dir`` search another corpus's train split,
  ``--data.retrieve_plot N`` draws N retrieval grids a split under
  ``{result_dir}/sk_analysis`` (PIL). Its result dir is the pretrain task's;
- ``finetune``: stage-2 training (train steps over the indication loader,
  then the no-indication loader; the optax-exact RAdam / AMSGrad chain in two
  groups), then beam decode of val and test on the eval path with their
  metrics and ``{split}_prediction.csv`` columns, every epoch; checkpoints
  under ``{result_dir}/checkpoint/`` (``current`` every ``save_period``
  epochs, ``best`` on monitor improvement), ``--trainer.resume auto|current|
  best`` and ``--trainer.load <slot dir or state dict file>`` (a pretrain
  slot seeds the shared encoders);
- ``test``: beam decode of the test split on the eval path, the metrics (NLG
  always; CheXbert on the device when ``--metrics.chexbert_checkpoint`` is
  set; the other CE metrics when their packages and checkpoints are there),
  ``test_prediction.csv`` with the metric rows first, ``test.log``,
  ``metrics.jsonl`` and ``config.json``; ``--trainer.plot_heatmaps N``
  then draws the cross-attention of every generated word of the first N
  test studies over their image (``{result_dir}/attentions``, PNG), as
  ``serve`` does too;
- ``score``: the NLG metrics of a predictions file (``--data.ann_path``: a
  ``test_prediction.csv`` or JSON ``{"gts": {id: text}, "res": {id: text}}``)
  as JSON on stdout; runs on the host;
- ``serve`` (streaming beam decode over the test split,
  ``serve_prediction.csv`` and a JSON throughput summary) with either engine:
  ``--decode.engine batch`` (the default: pipelined batches) or
  ``continuous`` (slots refilled mid-stream, ``decode/continuous.py``).
  ``--decode.serve_dp N`` serves over a pure-dp mesh of N ranks (-1: every
  visible card): under torchrun the process joins the existing group,
  otherwise the command spawns N ranks itself (NCCL on ``cuda:{rank}``, or
  gloo with ``--device cpu``). Each rank encodes and decodes its rows of
  every batch (the continuous engine: its share of the slots); rank 0
  prints ``serving mesh: dp=N``, writes ``serve_prediction.csv`` and the
  summary. N above the visible cards raises ``ValueError``.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, List, Optional

TASKS = ("pretrain", "finetune", "test", "retrieve", "score", "serve")


def build_model(cfg, vocab_size: int, device, task: str = "finetune"):
    """The model of ``evoke_tpu/cli.py`` build_model for ``task`` (the
    pretrain model for ``pretrain``, else the finetune model), on ``device``."""
    import torch

    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.models.pretrain import PretrainModel

    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    m = cfg.model
    partners = None if m.fusion_max_partners is None else int(m.fusion_max_partners)
    common = dict(
        vocab_size=vocab_size, d_vf=m.d_vf, output_dim=m.output_dim,
        encoder_hidden_size=m.encoder_hidden_size,
        encoder_num_layers=m.encoder_num_hidden_layers,
        encoder_num_heads=m.encoder_num_heads,
        encoder_intermediate_size=m.encoder_intermediate_size,
        proj_num_heads=m.proj_num_heads, fusion_wide_qkv=m.fusion_wide_qkv,
        fusion_max_partners=partners, remat_visual=m.remat_visual,
        is_multiview_learning=m.is_multiview_learning, dtype=dtype)
    with torch.device(device):
        if task == "pretrain":
            ls = cfg.loss
            return PretrainModel(instance_temp=ls.instance_temp, region_temp=ls.region_temp,
                                 pretrain_loss=ls.pretrain_loss,
                                 mul_pos_formulation=ls.mul_pos_formulation,
                                 mask_local_pad=ls.mask_local_pad, **common)
        return FinetuneModel(
            fusion_num_heads=m.fusion_num_heads,
            fusion_intermediate_size=m.fusion_intermediate_size,
            sk_fusion_num_layers=m.sk_fusion_num_layers, d_model=m.d_model, d_ff=m.d_ff,
            num_heads=m.num_heads, num_layers=m.num_layers, dropout=m.dropout,
            drop_prob_lm=m.drop_prob_lm, rm_num_slots=m.rm_num_slots,
            rm_num_heads=m.rm_num_heads, rm_d_model=m.rm_d_model,
            max_seq_len=cfg.data.max_seq_len, **common)


def build_loaders(cfg, tokenizer, ann, split: str = "test", train: bool = False,
                  task: str = "finetune", image_dir: str = ""):
    """One split's loaders, as ``evoke_tpu/cli.py`` build_loaders makes
    them: for the finetune model (with-indication, without-indication)
    (None where a stream is empty or indication is off); for ``task
    "pretrain"`` one loader of the split's ``align_text`` (keywords or
    report, no BOS / EOS). ``train``: the training transform and a shuffled
    order; ``image_dir`` (default ``data.image_dir``) where the images are."""
    from evoke_tpu_torch.data.batching import MultiviewBatcher
    from evoke_tpu_torch.data.datasets import parse_finetune, parse_pretrain
    from evoke_tpu_torch.data.transforms import make_transform

    common = dict(n_anchor=cfg.data.batch_size, max_seq_len=cfg.data.max_seq_len,
                  image_dir=image_dir or cfg.data.image_dir, num_workers=cfg.data.num_workers,
                  multiview=cfg.model.is_multiview_learning, shuffle=train)
    tf = make_transform(cfg.model.image_size, train, output_uint8=cfg.data.images_uint8)
    if task == "pretrain":
        return MultiviewBatcher(parse_pretrain(ann, split, cfg.data.align_type), tokenizer,
                                tf, **common)
    has_ind, no_ind = parse_finetune(ann, split)

    def mk(exs, with_ind):
        if not exs:
            return None
        return MultiviewBatcher(exs, tokenizer, tf, with_indication=with_ind,
                                text_field="report", add_bos_eos=True, **common)

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


ENGINES = ("batch", "continuous")


def _check_serve_config(cfg) -> None:
    if cfg.decode.engine not in ENGINES:
        raise ValueError(f"decode.engine={cfg.decode.engine!r}: one of {ENGINES}")
    if int(cfg.decode.serve_dp) < -1:
        raise ValueError(f"decode.serve_dp={cfg.decode.serve_dp}: 0 (one device), N > 0 "
                         "ranks or -1 (every visible card)")


def _serve_rank(mesh, argv: List[str]) -> None:
    """One spawned rank of ``serve --decode.serve_dp N``: the group is up,
    so ``main`` joins it."""
    main(argv)


def _serving_mesh(cfg, argv: List[str], device):
    """``--decode.serve_dp``: -> this process's mesh (it is a rank: spawned,
    or started by torchrun), or None once the ranks this call spawned have
    served."""
    import torch.distributed as dist

    from evoke_tpu_torch.core.mesh import (MeshSpec, check_devices, create_mesh,
                                           init_distributed, spawn, visible_devices)

    n = visible_devices(device) if int(cfg.decode.serve_dp) < 0 else int(cfg.decode.serve_dp)
    spec = MeshSpec(dp=n)
    check_devices(spec, device)
    if not dist.is_initialized() and "RANK" not in os.environ:
        spawn(_serve_rank, n, (argv,), device=device.type)
        return None
    init_distributed(device=device)
    mesh = create_mesh(spec, device=device.type)
    if mesh.rank == 0:
        print(f"serving mesh: dp={n}", flush=True)
    return mesh


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
    # serve keeps its own task name (results/{data}/serve/{version}); retrieve
    # runs under the pretrain task's
    cfg_task = {"retrieve": "pretrain"}.get(task, task)
    cfg = load_config(yaml_path, overrides={"trainer.task": cfg_task}, argv=rest)
    cfg.trainer.task = cfg_task
    if task == "score":
        return _score(cfg)
    if task == "serve":
        _check_serve_config(cfg)
    device = resolve_device(device)
    mesh = None
    if task == "serve" and cfg.decode.serve_dp:
        mesh = _serving_mesh(cfg, argv, device)
        if mesh is None:
            return 0
        device = mesh.device
    main_rank = mesh is None or mesh.rank == 0

    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.data.tokenizer import build_tokenizer
    from evoke_tpu_torch.params import init_params_

    from evoke_tpu_torch.parallel.collectives import barrier, broadcast_

    ann = load_annotation(cfg.data.ann_path)
    if not main_rank:
        barrier(mesh)    # rank 0 writes the tokenizer file first
    tokenizer = build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name,
                                ann_path=cfg.data.ann_path, model=cfg.data.tokenizer_model,
                                tokenizer_type=cfg.data.tokenizer_type)
    if main_rank and mesh is not None:
        barrier(mesh)
    cfg.vocab_size = tokenizer.get_vocab_size()
    model = build_model(cfg, cfg.vocab_size, device, cfg_task)
    init_params_(model, cfg.trainer.seed)
    model.eval()
    if task == "pretrain":
        return _pretrain(cfg, model, tokenizer, ann, device)
    if task == "retrieve":
        return _retrieve(cfg, model, tokenizer, ann, device)
    if task == "finetune":
        return _finetune(cfg, model, tokenizer, ann, device)
    loaders = build_loaders(cfg, tokenizer, ann)
    if task == "test":
        from evoke_tpu_torch.train.trainer import Tester

        # Tester loads --trainer.load into the model (BaseTrainer._partial_load)
        Tester(cfg, model, tokenizer, eval_loaders={"test": loaders},
               metrics_fn=metrics_fn_for(cfg, device), device=device).test()
        if cfg.trainer.plot_heatmaps > 0:
            _plot_heatmaps(cfg, model, tokenizer, loaders, device)
        return 0
    if cfg.trainer.load:
        from evoke_tpu_torch.core.checkpoint import partial_restore_from

        report = partial_restore_from(cfg.trainer.load, model)
        if main_rank:
            print(f"loaded weights: {report}")
    # every rank serves rank 0's weights
    broadcast_(list(model.parameters()) + list(model.buffers()), mesh)
    return _serve(cfg, model, tokenizer, loaders, device, mesh)


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


def _pretrain(cfg, model, tokenizer, ann, device) -> int:
    """Stage-1 training (``evoke_tpu/cli.py``'s pretrain task): the model
    initialised from the seed, the optimizer in one group at ``pt_lr`` (the
    state of ``init_pretrain_state``), PretrainTrainer over the train loader
    with val (and test) evaluated."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState
    from evoke_tpu_torch.train.trainer import PretrainTrainer

    o = cfg.optim
    opt = build_optimizer(o.optim, "pretrain", model, pt_lr=o.pt_lr, ft_lr=o.ft_lr,
                          weight_decay=o.weight_decay, grad_clip_value=o.grad_clip_value,
                          grad_accum_steps=o.grad_accum_steps)
    loaders = {split: build_loaders(cfg, tokenizer, ann, split, train=split == "train",
                                    task="pretrain") for split in ("train", "val", "test")}
    PretrainTrainer(cfg, model, tokenizer, TrainState(model, opt), train_loader=loaders["train"],
                    val_loader=loaders["val"], test_loader=loaders["test"],
                    device=device).train()
    return 0


def _retrieve(cfg, model, tokenizer, ann, device) -> int:
    """Stage 1.5 (``evoke_tpu/cli.py``'s retrieve task): the specific-knowledge
    annotation from an exact top-k search on the device.

    The database is the train split's (or ``retrieve_db_ann_path``'s train
    split's) anchors: ``encode_images`` on the eval path, flattened and
    stored as float16 on the host; a study's code is its image id, so only
    the query itself is excluded. As in the JAX CLI, which reads one batch of
    the train loader to initialise its model first, the same-corpus database
    is the pretrain train loader's second pass (shuffled, train transform);
    ``set_epoch(1)`` draws that pass. The train split is searched with its
    own database rows, val and test with theirs encoded likewise."""
    import numpy as np
    import torch

    from evoke_tpu_torch.core.checkpoint import partial_restore_from
    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.retrieval.topk import (TopKIndex, attach_specific_knowledge,
                                                stable_code)
    from evoke_tpu_torch.serve import staged_batches
    from evoke_tpu_torch.train.steps import maybe_normalize_images

    if cfg.trainer.load:
        print(f"loaded stage-1 weights: {partial_restore_from(cfg.trainer.load, model)}")

    @torch.inference_mode()
    def corpus(loader):
        embs, codes, ids = [], [], []
        prefetch = cfg.data.prefetch
        for batch, host in staged_batches(loader, device, prefetch):
            batch = maybe_normalize_images(batch)
            n_anchor = batch["ids"].shape[0]
            proj, _ = model.encode_images(batch["images"], batch["pids"], batch["valid"],
                                          n_anchor)
            keep = [i for i in range(n_anchor) if host["_valid"][i]]
            embs.append(proj.reshape(n_anchor, -1)[keep].to(torch.float16).cpu())
            ids += [host["_image_ids"][i] for i in keep]
        return (torch.cat(embs), np.asarray([stable_code(i) for i in ids], np.int64), ids)

    # cross-corpus mode: the database is another corpus's train split
    same_corpus = not cfg.data.retrieve_db_ann_path
    db_ann_path = cfg.data.retrieve_db_ann_path or cfg.data.ann_path
    if same_corpus:
        db_loader = build_loaders(cfg, tokenizer, ann, "train", train=True, task="pretrain")
        db_loader.set_epoch(1)
    else:
        db_loader = build_loaders(cfg, tokenizer, load_annotation(db_ann_path), "train",
                                  task="pretrain", image_dir=cfg.data.retrieve_db_image_dir)
    db_emb, db_codes, db_ids = corpus(db_loader)
    index = TopKIndex(db_emb, db_codes, db_ids, device=device)
    topk = cfg.data.retrieve_topk
    results = {}
    for split in ("train", "val", "test"):
        if split == "train" and same_corpus:
            q_emb, q_codes, q_ids = db_emb, db_codes, db_ids
        else:
            q_emb, q_codes, q_ids = corpus(build_loaders(cfg, tokenizer, ann, split,
                                                         task="pretrain"))
        _, idx = index.search(q_emb, q_codes, topk)
        results[split] = {qid: [db_ids[j] for j in row] for qid, row in zip(q_ids, idx)}
    out_path = cfg.data.ann_path.replace(".json", f"_best_reports_keywords_{topk}.json")
    # the knowledge (reports, keywords) comes from the database corpus's train items
    target_ann = load_annotation(cfg.data.ann_path)
    id_to_item = {str(it["id"]): it for it in load_annotation(db_ann_path).get("train", [])}
    for split in ("train", "val", "test"):
        attach_specific_knowledge(target_ann, split, results[split], id_to_item, topk)
    with open(out_path, "w") as f:
        json.dump(target_ann, f)
    print(f"wrote {out_path}")
    if cfg.data.retrieve_plot > 0:
        from evoke_tpu_torch.retrieval.topk import plot_topk_images

        plot_dir = os.path.join(cfg.result_dir, "sk_analysis")
        for split in ("train", "val", "test"):
            wrote = plot_topk_images(
                target_ann, split, id_to_item, cfg.data.image_dir, plot_dir,
                topk=min(topk, 3), n_studies=cfg.data.retrieve_plot,
                db_image_dir=cfg.data.retrieve_db_image_dir or None)
            print(f"wrote {len(wrote)} {split} retrieval grids to {plot_dir}")
    return 0


def _serve(cfg, model, tokenizer, test_loaders, device, mesh=None) -> int:
    """Streaming inference over the test split: pipelined beam decode by the
    batch or the continuous engine, predictions CSV and a throughput summary
    (no metric scoring). Under a dp ``mesh`` every rank serves its rows and
    gets every record; rank 0 writes the CSV and prints the summary."""
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
            kv_cache_dtype=d.kv_cache_dtype, device=device, mesh=mesh)
        for loader in (inc, no):
            if loader is None:
                continue
            recs, st = server.serve(loader, prefetch=cfg.data.prefetch)
            records.extend(recs)
            stats.append(st)
    else:
        from evoke_tpu_torch.serve import ReportServer

        server = ReportServer(model, tokenizer, cfg.decode, max_seq_len=cfg.data.max_seq_len,
                              device=device, mesh=mesh)
        for loader, with_ind in ((inc, True), (no, False)):
            if loader is None:
                continue
            records.extend(server.serve(loader, with_indication=with_ind))
            stats.append(dict(server.stats))
    if mesh is not None and mesh.rank != 0:
        return 0
    os.makedirs(cfg.result_dir, exist_ok=True)
    out_path = os.path.join(cfg.result_dir, "serve_prediction.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["images_id", "generated_reports", "ground_truth"])
        for r in records:
            w.writerow([r["id"], r["report"], r.get("gt", "")])
    wall = sum(s["wall_s"] for s in stats)
    n = int(sum(s["reports"] for s in stats))
    summary = {"reports": n, "wall_s": round(wall, 3),
               "reports_per_s": round(n / wall, 3) if wall else None,
               "prediction_csv": out_path}
    if cfg.trainer.plot_heatmaps > 0:
        _plot_heatmaps(cfg, model, tokenizer, test_loaders, device)
    print(json.dumps(summary))
    return 0


def _plot_heatmaps(cfg, model, tokenizer, test_loaders, device) -> List[str]:
    """Cross-attention overlays of every generated word for the first
    ``trainer.plot_heatmaps`` test studies (``evoke_tpu/cli.py``
    _plot_heatmaps): the first batch of each test loader decoded on the eval
    path, then ``evals/heatmaps.render_generation_heatmaps`` into
    ``{result_dir}/attentions``. Returns the written paths."""
    import numpy as np
    import torch

    from evoke_tpu_torch.evals.heatmaps import render_generation_heatmaps
    from evoke_tpu_torch.train.steps import make_generate_step

    n = cfg.trainer.plot_heatmaps
    out_dir = os.path.join(cfg.result_dir, "attentions")
    written: List[str] = []
    for loader, with_ind in zip(test_loaders, (True, False)):
        if loader is None or n <= 0:
            continue
        batch = next(iter(loader))
        data = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
                if not k.startswith("_")}
        gen = make_generate_step(model, tokenizer, cfg.decode, cfg.data.max_seq_len,
                                 with_indication=with_ind, device=device)
        seqs = gen(data).cpu().numpy()
        take = min(n, int(np.asarray(batch["valid"])[: seqs.shape[0]].sum()))
        written += render_generation_heatmaps(
            model, data, seqs, tokenizer, out_dir, cfg.model.num_layers,
            study_ids=list(batch["_image_ids"]), max_studies=take, with_indication=with_ind)
        n -= take
    print(f"wrote {len(written)} heatmap PNGs to {out_dir}")
    return written


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
