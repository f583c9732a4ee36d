"""Rank bodies of the port's tensor-parallel tests (tests/test_torch_port_tp_spawn.py).

As in ``_torch_port_dp.py``, each body runs in a process that
``evoke_tpu_torch.core.mesh.spawn`` starts per rank, so this module imports
``torch``, ``numpy`` and the port only: a rank never imports JAX. The pytest
process writes the inputs with ``torch.save``, each rank reads them, runs
its cases and writes ``rank{r}.pt`` beside them; the pytest process computes
the JAX and one-device references and compares.
"""

import hashlib
import math
import os

import torch

from _torch_port_dp import LR, _load, _save, finetune_model, pretrain_model
from evoke_tpu_torch.train.optim import param_label


def spawn_tp(body, path, dp, mp, timeout_s=240):
    """Run ``body(mesh, path)`` on ``dp * mp`` gloo ranks on the CPU ->
    each rank's saved results, in rank order."""
    from evoke_tpu_torch.core.mesh import MeshSpec, spawn

    d = os.path.dirname(path)
    spawn(body, args=(path,), spec=MeshSpec(dp=dp, mp=mp), device="cpu",
          init_method="file://" + os.path.join(d, "rendezvous"), timeout_s=timeout_s)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(dp * mp)]


def digest(tensors):
    """A checksum of a name -> tensor mapping (bit for bit)."""
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def full_opt(state):
    """The optimizer's moments by parameter name, gathered over mp."""
    from evoke_tpu_torch.parallel.tp import gather_full

    d = state.opt.state_dict()
    return {slot: gather_full(d[slot], state.model) for slot in ("mu", "nu") if slot in d}


def state_digest(state):
    """A checksum of the full (gathered) parameters, buffers and moments."""
    from evoke_tpu_torch.parallel.tp import full_state_dict

    full = full_state_dict(state.model)
    full.update({f"{slot}:{k}": v for slot, d in full_opt(state).items() for k, v in d.items()})
    return digest(full)


def check_step(before, want_metrics, want, got_metrics, got, params, task):
    """The data-parallel tests' bounds (tests/test_torch_port_parallel.py)
    on a train step against the one-rank step -> the
    problems found (empty when it holds): the loss within 1e-5 relative; a
    parameter within 1e-5 relative of the one-rank value, its update within
    1e-3 of RAdam's first step (lr x the clip, 0.1) of the one-rank update, a
    ResNet parameter's within 2e-2 of it in L2 norm; BatchNorm statistics
    within 1e-5 relative; most of the state moved."""
    problems = []
    if sorted(got_metrics) != sorted(want_metrics):
        problems.append(f"metrics {sorted(got_metrics)}")
    for k, w in want_metrics.items():
        if not math.isclose(got_metrics.get(k, math.nan), w, rel_tol=1e-5, abs_tol=1e-7):
            problems.append(f"metric {k}: {got_metrics.get(k)} vs {w}")
    moved = 0
    for name, w in want.items():
        g = got[name]
        if g.shape != w.shape:
            problems.append(f"{name}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
            continue
        moved += not torch.equal(w, before[name])
        lr = LR["ft_lr" if task == "finetune" and param_label(name) == "ft" else "pt_lr"]
        resnet = name.startswith("visual_extractor.backbone")
        step = (1.0 if resnet else 1e-3) * 0.1 * lr if name in params else 0.0
        tol = 1e-5 * w.abs() + 1e-5 * w.abs().max() + step + 1e-12
        if not ((g - w).abs() <= tol).all():
            problems.append(f"{name}: {(g - w).abs().max().item():.3e} off")
        if name not in params:
            continue
        err = (g - before[name]) - (w - before[name])
        ulp = 2 * torch.finfo(torch.float32).eps * w.abs()
        if resnet:
            if err.norm() > 2e-2 * (w - before[name]).norm() + ulp.norm():
                problems.append(f"{name}: update off by {err.norm().item():.3e} in L2")
        elif not (err.abs() <= step + ulp).all():
            problems.append(f"{name}: update off by {(err.abs().max() / step).item():.2f} "
                            "of its bound")
    if moved <= len(want) // 2:
        problems.append(f"only {moved} of {len(want)} entries moved")
    return problems


def tp_train(model, batch, mesh, task, with_indication, seed=3, state=None):
    """One train step (dropout on, RAdam at ``LR``) of ``model``, sharded
    over ``mesh`` first unless ``state`` is given -> (metrics, state)."""
    from evoke_tpu_torch.parallel.tp import shard_params_tp
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_train_step

    if state is None:
        shard_params_tp(model, mesh)
        state = TrainState(model, build_optimizer("RAdam", task, model, weight_decay=1e-4,
                                                  **LR))
    step = make_train_step(model, state.opt, seed, "all_loss",
                           with_indication=with_indication, task=task, mesh=mesh)
    model.train()
    metrics = step(state, batch)
    model.eval()
    return {k: float(v) for k, v in metrics.items()}, state


def step_summary(model, before, want_metrics, want, metrics, task):
    """A rank's train step held against the one-rank step (``check_step``),
    with the checksums of its replicated parameters and of its full state."""
    from evoke_tpu_torch.parallel.tp import full_state_dict, split_dims

    split = split_dims(model)
    return {"problems": check_step(before, want_metrics, want, metrics,
                                   full_state_dict(model),
                                   dict(model.named_parameters()).keys(), task),
            "local_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()
                             if n in split},
            "replicated": digest({n: p for n, p in model.named_parameters()
                                  if n not in split}),
            "full": digest(full_state_dict(model))}


def slot_state(path):
    """A ``TrainState`` checkpoint file -> (its parameters and buffers, its
    moments)."""
    blob = torch.load(os.path.join(path, "current", "state.pt"), weights_only=True)
    return {**blob["params"], **blob["buffers"]}, {k: blob["opt"][k] for k in ("mu", "nu")}


def wide_fusion_module(inp, mesh):
    """The wide fusion attention (K3's route: the plain version on the CPU)
    sharded over ``mesh``'s mp -> (output, the module's local head count)."""
    from evoke_tpu_torch.models.fusion import BatchedCrossViewAttention
    from evoke_tpu_torch.parallel.tp import shard_params_tp

    m = BatchedCrossViewAttention(**inp["fusion_dims"], wide_qkv=True, use_pallas=True)
    m.load_state_dict(inp["fusion_sd"])
    shard_params_tp(m, mesh)
    with torch.no_grad():
        out = m(*inp["fusion_args"])
    return out, m.num_heads


def tp_cases(mesh, path):
    """The dp=2 x mp=2 cases of test_torch_port_tp_spawn.py on this rank."""
    from evoke_tpu_torch.core.checkpoint import CheckpointManager
    from evoke_tpu_torch.core.config import DecodeConfig
    from evoke_tpu_torch.core.mesh import shard_batch
    from evoke_tpu_torch.decode.continuous import ContinuousServer
    from evoke_tpu_torch.models.finetune import FinetuneModel
    from evoke_tpu_torch.parallel.collectives import all_gather_batch
    from evoke_tpu_torch.parallel.tp import full_state_dict, shard_params_tp
    from evoke_tpu_torch.params import init_params_
    from evoke_tpu_torch.serve import ReportServer
    from evoke_tpu_torch.train.optim import build_optimizer
    from evoke_tpu_torch.train.steps import TrainState, make_generate_step

    inp = _load(path)
    d = os.path.dirname(path)
    out = {"layout": (mesh.dp_rank, mesh.mp_rank),
           "rows": shard_batch({"x": inp["rows"]}, mesh)["x"].numpy(),
           "gathered": tuple(all_gather_batch(torch.ones(3, 2), mesh).shape)}
    fsd = inp["finetune_sd"]

    def finetune():
        return finetune_model(inp["dims"], inp["vocab"], fsd)

    # train steps (dropout on) against the one-rank step: the finetune one
    # took the model to the one-device slot one_ckpt
    fb = shard_batch(inp["finetune_batch"], mesh)
    m = finetune()
    metrics, _ = tp_train(m, fb, mesh, "finetune", True)
    one, one_opt = slot_state(inp["one_ckpt"])
    out["finetune"] = step_summary(m, fsd, inp["one_metrics"][0], one, metrics, "finetune")
    pm = pretrain_model(inp["pretrain_dims"], inp["vocab"], inp["pretrain_sd"])
    metrics, _ = tp_train(pm, shard_batch(inp["pretrain_batch"], mesh), mesh, "pretrain",
                          False)
    out["pretrain"] = step_summary(pm, inp["pretrain_sd"], *inp["pretrain_want"], metrics,
                                   "pretrain")
    del m, pm

    # checkpoints across layouts: the one-device slot restores here bit for
    # bit; one more step against the one-device second step; saved here
    m = shard_params_tp(finetune(), mesh)
    state = TrainState(m, build_optimizer("RAdam", "finetune", m, weight_decay=1e-4, **LR))
    meta = CheckpointManager(inp["one_ckpt"], mesh=mesh).restore("current", state)
    full, opt = full_state_dict(m), full_opt(state)
    out["restored"] = {"step": state.step, "meta": meta,
                       "unequal": sorted(k for k, v in one.items() if not torch.equal(full[k], v))
                       + sorted(f"{slot}:{k}" for slot, t in one_opt.items() for k, v in t.items()
                                if not torch.equal(opt[slot][k], v))}
    metrics, state = tp_train(m, fb, mesh, "finetune", True, state=state)
    two, _ = slot_state(inp["one_ckpt2"])
    out["step2"] = step_summary(m, one, inp["one_metrics"][1], two, metrics, "finetune")
    del one, one_opt, two, full, opt
    CheckpointManager(os.path.join(d, "tp_ckpt"), mesh=mesh).save("current", state,
                                                                  {"epoch": 2})
    out["step2"]["state"] = state_digest(state)
    del m, state

    # decoding: beam 3 (float32 and int8 caches), the servers
    gm = shard_params_tp(finetune(), mesh)
    tok = inp["tokenizer"]
    db = shard_batch(inp["decode_batch"], mesh)
    for name, cfg in (("beam3", DecodeConfig(beam_size=3)),
                      ("int8", DecodeConfig(beam_size=3, kv_cache_dtype="int8"))):
        gen = make_generate_step(gm, tok, cfg, 16, with_indication=True, serving=True,
                                 device="cpu", mesh=mesh)
        out[name] = (all_gather_batch(gen(db), mesh).numpy(), gen.captured, gen.ancestor_kv,
                     gen.fused_topk)
    server = ReportServer(gm, tok, DecodeConfig(beam_size=3), 16, device="cpu", mesh=mesh)
    out["report_server"] = (server.serve(inp["loader"], with_indication=True),
                            server.stats["captured"])
    srv = ContinuousServer(gm, tok, max_seq_len=16, slots=4, beam_size=3, seg_steps=4,
                           dispatch_segs=2, pack_batches=2, device="cpu", mesh=mesh)
    recs, stats = srv.serve(inp["loader"])
    out["continuous"] = (recs, stats["reports"], stats["captured"])
    del gm, server, srv

    # the wide fusion: the module on the rank's heads, and its train step
    out["fusion"] = wide_fusion_module(inp, mesh)
    wm = FinetuneModel(vocab_size=inp["vocab"], **inp["wide_dims"])
    init_params_(wm, 1)
    before = {k: v.clone() for k, v in wm.state_dict().items()}
    metrics, _ = tp_train(wm, shard_batch(inp["wide_batch"], mesh), mesh, "finetune", True)
    out["wide"] = step_summary(wm, before, *inp["wide_want"], metrics, "finetune")
    _save(mesh, out, d)


def decode_logits(dec, att, att_mask, ids):
    """The R2Gen decoder's logits at every step of a cached decode of
    ``ids`` [N, T] (one row a sample), no grad -> (logits [T, N, V],
    the steps that took the stacked CLN pass, whether it holds the pack)."""
    with torch.no_grad():
        st = dec.init_decode_state(dec.encode(att, att_mask), ids.shape[0], ids.shape[1])
        out = []
        for pos in range(ids.shape[1]):
            tl, st = dec.decode_step(ids[:, pos], pos, st, att_mask, return_logits=True)
            out.append(tl)
    return torch.stack(out).numpy(), dec.stacked_cln_steps, dec._cln_pack is not None


def mp_cases(mesh, path):
    """The mp=2 cases of test_torch_port_tp_spawn.py on this rank."""
    from evoke_tpu_torch.models.layers import MultiHeadAttention
    from evoke_tpu_torch.models.rm_decoder import RMDecoder
    from evoke_tpu_torch.parallel.tp import shard_params_tp

    inp = _load(path)
    dec = RMDecoder(**inp["decoder_dims"])
    dec.load_state_dict(inp["decoder_sd"])
    shard_params_tp(dec, mesh)
    with torch.no_grad():
        out = {"decoder": dec(*inp["decoder_args"]).numpy(),
               "decoder_heads": [layer.self_attn.num_heads for layer in dec.dec_layers]}
    att, att_mask, ids, _ = inp["decoder_args"]
    out["decode"] = decode_logits(dec, att, att_mask, ids)
    mha = MultiHeadAttention(3, 12)
    mha.load_state_dict(inp["mha_sd"])
    shard_params_tp(mha, mesh)
    with torch.no_grad():
        out["odd_heads"] = (mha(*inp["mha_args"]).numpy(), mha.num_heads, mha.tp is None,
                            tuple(mha.wq.weight.shape))
    out["fusion"] = wide_fusion_module(inp, mesh)
    _save(mesh, out, os.path.dirname(path))
