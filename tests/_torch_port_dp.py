"""Rank bodies of the port's data-parallel tests (tests/test_torch_port_parallel*.py).

Each body runs in a process that ``evoke_tpu_torch.core.mesh.spawn`` starts
per rank, so this module imports ``torch``, ``numpy`` and the port only: a
rank never imports JAX. The pytest process writes the inputs (the model's
dims and weights, the global batches) with ``torch.save``, each rank reads
them, runs its cases on its rows and writes ``rank{r}.pt`` beside them; the
pytest process computes the JAX and one-device references and compares.
"""

import os

import torch


def _load(path):
    torch.set_num_threads(1)
    return torch.load(path, weights_only=False)


def _save(mesh, obj, out_dir):
    torch.save(obj, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def finetune_model(dims, vocab, state_dict, **kw):
    from evoke_tpu_torch.models.finetune import FinetuneModel

    m = FinetuneModel(vocab_size=vocab, **dims, **kw)
    m.load_state_dict(state_dict)
    return m.eval()


def pretrain_model(dims, vocab, state_dict):
    from evoke_tpu_torch.models.pretrain import PretrainModel

    m = PretrainModel(vocab_size=vocab, **dims)
    m.load_state_dict(state_dict)
    return m.eval()


def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


LR = dict(pt_lr=5e-6, ft_lr=5e-5)    # the config's defaults


def train_once(model, batch, mesh, task, with_indication, seed=3):
    """One train step (dropout on, RAdam at ``LR``) of ``model`` over
    ``batch`` (this rank's rows under ``mesh``; the global batch without
    one) -> (metrics, the model's state dict after it)."""
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    opt = build_optimizer("RAdam", task, model, weight_decay=1e-4, **LR)
    loss_key = "all_loss"
    step = make_train_step(model, opt, seed, loss_key, with_indication=with_indication,
                           task=task, mesh=mesh)
    model.train()
    metrics = step(TrainState(model, opt), batch)
    model.eval()
    return {k: float(v) for k, v in metrics.items()}, params_of(model)


def eval_once(model, batch, mesh, with_indication):
    from evoke_tpu_torch.train.steps import make_eval_step

    out = make_eval_step(model, with_indication=with_indication, mesh=mesh)(None, batch)
    return {k: float(v) for k, v in out.items()}


def contrastive(mesh, embed, pids, valid, temp):
    """multi_positive_image_loss over the ranks' rows through
    ``make_shardmap_loss`` -> (loss, the gradient of this rank's rows)."""
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.losses.contrastive import multi_positive_image_loss
    from evoke_tpu_torch.parallel.collectives import make_shardmap_loss

    local = shard_batch({"e": embed, "p": pids, "v": valid}, mesh)
    e = local["e"].clone().requires_grad_(True)
    run = make_shardmap_loss(mesh, lambda a, p, v: multi_positive_image_loss(a, p, v, temp))
    loss = run(e, local["p"], local["v"])
    (loss / mesh.dp).backward()
    return float(loss), e.grad.clone()


def losses_and_steps(mesh, path):
    """Case (b) and (c) of test_torch_port_parallel.py on this rank."""
    from evoke_tpu_torch.core.mesh import shard_batch

    from evoke_tpu_torch.core.mesh import MeshSpec, create_mesh

    inp = _load(path)
    out = {"contrastive": contrastive(mesh, *inp["contrastive"])}
    try:
        create_mesh(MeshSpec(dp=2, mp=2), device="cpu")
    except ValueError as e:
        out["mp_refusal"] = ("ValueError", str(e))
    fb = inp["finetune_batch"]
    sharded = shard_batch(fb, mesh)
    m = finetune_model(inp["dims"], inp["vocab"], inp["finetune_sd"])
    out["finetune_eval"] = eval_once(m, sharded, mesh, True)
    out["finetune_train"] = train_once(m, sharded, mesh, "finetune", True)
    pb = shard_batch(inp["pretrain_batch"], mesh)
    pm = pretrain_model(inp["pretrain_dims"], inp["vocab"], inp["pretrain_sd"])
    out["pretrain_eval"] = eval_once(pm, pb, mesh, False)
    out["pretrain_train"] = train_once(pm, pb, mesh, "pretrain", False)
    _save(mesh, out, os.path.dirname(path))


def serving(mesh, path):
    """Cases (d) and (e) of test_torch_port_parallel_serve.py on this rank:
    make_generate_step(mesh=) on this rank's rows, ReportServer(mesh=) and
    ContinuousServer(mesh=) over the same loader."""
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.serve import ReportServer
    from evoke_tpu_torch.train.steps import make_generate_step

    inp = _load(path)
    m = finetune_model(inp["dims"], inp["vocab"], inp["sd"])
    tok = inp["tokenizer"]
    batch = inp["batch"]
    gen = make_generate_step(m, tok, DecodeConfig(beam_size=3), 16, with_indication=True,
                             serving=True, device="cpu", mesh=mesh)
    out = {"tokens": gen(shard_batch(batch, mesh)).numpy()}
    out["report_server"] = ReportServer(m, tok, DecodeConfig(beam_size=3), 16, device="cpu",
                                        mesh=mesh).serve(inp["loader"], with_indication=True)
    srv = ContinuousServer(m, tok, max_seq_len=16, slots=4, beam_size=3, seg_steps=4,
                           dispatch_segs=2, pack_batches=2, device="cpu", mesh=mesh)
    recs, stats = srv.serve(inp["loader"])
    out["continuous"] = (recs, stats["reports"])
    _save(mesh, out, os.path.dirname(path))


def spawn_case(body, path, world_size=2, timeout_s=150):
    """Run ``body(mesh, path)`` on ``world_size`` gloo ranks on the CPU (a
    ``file://`` rendezvous beside ``path``, so concurrent test processes
    never share a port) -> each rank's saved results."""
    from evoke_tpu_torch.core.mesh import spawn

    d = os.path.dirname(path)
    spawn(body, world_size, (path,), device="cpu",
          init_method="file://" + os.path.join(d, "rendezvous"), timeout_s=timeout_s)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world_size)]



def trainer_run(mesh, root, task, version):
    """``task``'s trainer for ``trainer.epochs`` over the synthetic dataset
    in ``root`` with the CLI's loaders and the argv in ``root/argv.json``
    (the tokenizer already built there), seeded init, under ``mesh`` (None:
    one process) -> (the last epoch's log, a checksum of the parameters)."""
    import hashlib
    import json

    from evoke_tpu_torch import cli
    from evoke_tpu_torch.core.config import load_config
    from evoke_tpu_torch.data.datasets import load_annotation
    from evoke_tpu_torch.data.tokenizer import build_tokenizer
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState
    from evoke_tpu_torch.train.trainer import FinetuneTrainer, PretrainTrainer

    torch.set_num_threads(1)
    with open(os.path.join(root, "argv.json")) as f:
        argv = json.load(f) + ["--trainer.version", version]
    cfg = load_config(None, overrides={"trainer.task": task}, argv=argv)
    ann = load_annotation(cfg.data.ann_path)
    tok = build_tokenizer(cfg.data.tokenizer_dir, cfg.data.data_name, ann_path=cfg.data.ann_path)
    model = cli.build_model(cfg, tok.get_vocab_size(), torch.device("cpu"), task)
    init_params_(model, 0)
    o = cfg.optim
    state = TrainState(model, build_optimizer(o.optim, task, model, pt_lr=o.pt_lr,
                                              ft_lr=o.ft_lr, weight_decay=o.weight_decay))
    splits = ("train", "val", "test")
    if task == "pretrain":
        ld = {s: cli.build_loaders(cfg, tok, ann, s, train=s == "train", task=task)
              for s in splits}
        trainer = PretrainTrainer(cfg, model, tok, state, ld["train"], ld["val"], ld["test"],
                                  device="cpu", mesh=mesh)
    else:
        ld = {s: cli.build_loaders(cfg, tok, ann, s, train=s == "train") for s in splits}
        trainer = FinetuneTrainer(cfg, model, tok, {"val": ld["val"], "test": ld["test"]},
                                  state=state, train_loaders=ld["train"], device="cpu",
                                  mesh=mesh)
    log = trainer.train()
    digest = hashlib.sha256(b"".join(p.detach().numpy().tobytes()
                                     for p in model.parameters())).hexdigest()
    return log, digest


def trainers(mesh, path):
    """Both trainers on this rank (test_torch_port_parallel_trainer.py)."""
    root = os.path.dirname(path)
    _save(mesh, {task: trainer_run(mesh, root, task, f"dp_{task}")
                 for task in ("pretrain", "finetune")}, root)
