"""Port parity: finetune training (losses/lm.py, train/optim.py, the train and
eval steps, the trainer's monitor, checkpoints, resume and ``cli finetune``),
each against its JAX counterpart on the same numpy-seeded inputs, on the CPU
at float32.

Dropout is off on both sides of a parity step: JAX's through
``flax.linen.intercept_methods`` (every ``nn.Dropout.__call__`` returns its
input; the package itself is untouched), the port's by ``dropout=False``.
BatchNorm stays in training mode on both.

Tolerances, and why:

- ``lm_loss``: 1e-6 relative.
- The optimizer alone against optax over 10 updates: parameters 1e-6
  relative (of the leaf's largest, for elements near 0), each update 1e-5 of the leaf's largest update plus the rounding
  of p + u (XLA fuses the chain and may contract a multiply-add; the scalars
  are bit-equal).
- One train step: the loss 1e-5 relative; BatchNorm's running statistics 1e-4
  of the leaf's largest value; gradients outside the ResNet 1e-3 of (the
  leaf's largest + 1e-3 of the largest gradient); the ResNet's gradients
  3e-2 in L2 norm relative. The ResNet is the loose one on purpose: 33
  Bottlenecks of batch-statistics BatchNorm over 4 images amplify float32
  rounding ~1.3x per block, so its float32 gradients are only that accurate
  (the port's own float32 step differs from its float64 step by as much), in
  JAX too. The step's weights damp each Bottleneck's bn3 scale by 0.1 (the
  zero-init-residual idea) to keep the forward well conditioned, and
  ``test_bottleneck_train_mode_equals_jax`` holds one block's gradients at
  1e-5. Updated parameters: within the step's gradient difference times the
  learning rate, plus 1e-6 relative.
"""

import copy
import csv
import json
import math
import os

import numpy as np
import pytest
import torch
import flax.linen as nn
import jax
import jax.numpy as jnp

from evoke_tpu.core import config as jconfig
from evoke_tpu.core import prng as jprng
from evoke_tpu.losses.lm import lm_loss as jlm_loss
from evoke_tpu.models.resnet import Bottleneck as JBottleneck
from evoke_tpu.train import optim as joptim
from evoke_tpu.train import steps as jsteps
from evoke_tpu.train import trainer as jtrainer
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.core import config as tconfig
from evoke_tpu_torch.core import prng as tprng
from evoke_tpu_torch.losses.lm import lm_loss as tlm_loss
from evoke_tpu_torch.models.heads import ProjectionHead
from evoke_tpu_torch.models.layers import BatchNorm, commit_batch_stats, dropout
from evoke_tpu_torch.models.resnet import Bottleneck as TBottleneck
from evoke_tpu_torch.params import flax_to_state_dict, load_flax_variables
from evoke_tpu_torch.train import optim as toptim
from evoke_tpu_torch.train import steps as tsteps
from evoke_tpu_torch.train import trainer as ttrainer
from evoke_tpu_torch.data.synthetic import write_synthetic_dataset

from _torch_port_util import (damped, example_batch, no_dropout, recording, tiny_pair,
                              torch_batch)

torch.set_num_threads(2)


def nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


# ---- the loss ----

@pytest.mark.parametrize("with_sample_mask", [False, True])
def test_lm_loss_equals_jax(with_sample_mask):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ids = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.8).astype(np.int32)
    valid = np.array([True, False, True]) if with_sample_mask else None
    want = float(jlm_loss(logp, ids, mask, valid))
    got = float(tlm_loss(torch.as_tensor(logp), torch.as_tensor(ids), torch.as_tensor(mask),
                         None if valid is None else torch.as_tensor(valid)))
    assert math.isclose(got, want, rel_tol=1e-6), (got, want)


# ---- the optimizer alone ----

class _Leaves(torch.nn.Module):
    """A module whose parameters carry the given dotted names."""

    def __init__(self, values):
        super().__init__()
        for name, v in values.items():
            mod = self
            *path, leaf = name.split(".")
            for k in path:
                if not hasattr(mod, k):
                    mod.add_module(k, torch.nn.Module())
                mod = getattr(mod, k)
            mod.register_parameter(leaf, torch.nn.Parameter(torch.as_tensor(v).clone()))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["RAdam", "AdamW"])
def test_optimizer_equals_optax(name, accum):
    """10 updates (RAdam rectifies from count 6 on), two groups, weight
    decay, clipping engaged on some steps, an lr_scale change, and
    grad_accum_steps 2 (optax.MultiSteps: 20 calls, zero updates between)."""
    rng = np.random.default_rng(1)
    shapes = {"text_decoder.w": (3, 4), "visual_extractor.w": (5,), "visual_head.b": (2, 2),
              "fusion.k": (6,)}
    init = {n: (rng.normal(size=s) * 1e-3).astype(np.float32) for n, s in shapes.items()}
    params = jax.tree_util.tree_map(jnp.asarray, nest(init))
    kw = dict(pt_lr=1e-3, ft_lr=1e-2, weight_decay=1e-2, grad_clip_value=0.1,
              grad_accum_steps=accum)
    tx = joptim.build_optimizer(name, "finetune", params, **kw)
    jstate = tx.init(params)
    update = jax.jit(tx.update)
    module = _Leaves(init)
    opt = toptim.build_optimizer(name, "finetune", module, **kw)
    assert sorted(opt.groups) == ["ft", "pt"]
    for call in range(10 * accum):
        grads = {n: (rng.normal(size=s) * (0.3 if call % 3 else 0.02)).astype(np.float32)
                 for n, s in shapes.items()}
        if call == 4 * accum:
            joptim.set_lr_scale(jstate, 0.5)
            toptim.set_lr_scale(opt, 0.5)
        before = {n: p.detach().clone() for n, p in module.named_parameters()}
        upd, jstate = update(nest({n: jnp.asarray(g) for n, g in grads.items()}), jstate, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, upd)
        moved = opt.step({n: torch.as_tensor(g) for n, g in grads.items()})
        assert moved == ((call + 1) % accum == 0)
        jflat = {".".join(k.key for k in path): np.asarray(v) for path, v in
                 jax.tree_util.tree_flatten_with_path(params)[0]}
        jupd = {".".join(k.key for k in path): np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(upd)[0]}
        for n, p in module.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got, jflat[n], rtol=1e-6,
                                       atol=1e-6 * np.abs(jflat[n]).max(), err_msg=n)
            delta = got - before[n].numpy()     # exact up to the rounding of p + u
            bound = 1e-5 * np.abs(jupd[n]).max() + 2 * np.spacing(np.abs(got)).max()
            assert np.abs(delta - jupd[n]).max() <= bound, (call, n)
    assert opt.count == 10 and toptim.radam_scalars(6)[0] and not toptim.radam_scalars(5)[0]


def test_optimizer_rejects_an_unknown_name():
    with pytest.raises(ValueError, match="RAdam"):
        toptim.build_optimizer("Radam", "finetune", _Leaves({"w": np.zeros(2, np.float32)}),
                               pt_lr=1e-3, ft_lr=1e-3, weight_decay=0.0)


def test_param_labels_equal_jax():
    """The port's two groups are JAX's _param_labels, leaf for leaf."""
    _, v, tm, _ = tiny_pair()
    labels = joptim._param_labels(v["params"])
    marks = jax.tree_util.tree_map(lambda lab, p: np.full(np.shape(p), lab == "ft"),
                                   labels, v["params"])
    want = {k: bool(a.flat[0]) for k, a in flax_to_state_dict({"params": marks}).items()}
    got = {n: toptim.param_label(n) == "ft" for n, _ in tm.named_parameters()}
    assert got == want
    assert 0 < sum(got.values()) < len(got)


@pytest.mark.parametrize("name", ["StepLR", "ReduceLROnPlateau", "WarmupCosine"])
@pytest.mark.parametrize("mode", ["min", "max"])
def test_schedulers_equal_jax(name, mode):
    kw = dict(step_size=3, gamma=0.5, warmup_epochs=2, max_epochs=9)
    js, ts = joptim.build_scheduler(name, mode, **kw), toptim.build_scheduler(name, mode, **kw)
    if name == "ReduceLROnPlateau":
        js.patience = ts.patience = 2
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 1.2, 0.5, None, 0.6, 0.7, 0.8, 0.9]
    for epoch, m in enumerate(metrics, 1):
        assert ts.update(epoch, m) == js.update(epoch, m), (epoch, m)
    if hasattr(js, "state_dict"):
        assert ts.state_dict() == js.state_dict()


# ---- modules in training mode ----

def test_batchnorm_train_mode_equals_flax():
    """Batch statistics (flax's fast variance), the output, its gradient and
    the running update, over a channels-last batch."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(6, 5, 7)) * 2 + 1).astype(np.float32)
    scale = rng.normal(size=7).astype(np.float32)
    bias = rng.normal(size=7).astype(np.float32)
    jb = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.full(7, 0.3, np.float32), "var": np.full(7, 2.0, np.float32)}}
    w = rng.normal(size=x.shape).astype(np.float32)

    def jf(params, x):
        y, mut = jb.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        v["params"], x)
    bn = BatchNorm(7, eps=1e-5)
    load_flax_variables(bn, v)
    tx = torch.as_tensor(x).requires_grad_(True)
    ty = bn(tx, train=True)
    (ty * torch.as_tensor(w)).sum().backward()
    assert torch.equal(bn.running_mean, torch.full((7,), 0.3))    # pending until commit
    bn.commit()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), jg["scale"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), jg["bias"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), jstats["mean"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), jstats["var"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_bottleneck_train_mode_equals_jax(remat):
    """One projecting Bottleneck in training mode (conv + batch-statistics
    BN): output, input and weight gradients, running statistics, at 1e-5;
    ``remat`` checkpoints it as ResNet101(remat=True) does, and BN's update
    still lands once."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8, 8, 16)).astype(np.float32)
    jblk = JBottleneck(8, stride=2, project=True)
    v = jax.device_get(jblk.init(jax.random.key(0), x, train=False))
    w = rng.normal(size=(4, 4, 4, 32)).astype(np.float32)

    def jf(params, x):
        y, mut = jblk.apply({"params": params, "batch_stats": v["batch_stats"]}, x, True,
                            mutable=["batch_stats"])
        return jnp.sum(y * w), mut["batch_stats"]

    (_, jstats), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        v["params"], x)
    blk = TBottleneck(16, 8, stride=2, project=True)
    load_flax_variables(blk, v)
    tx = torch.as_tensor(x).requires_grad_(True)
    xin = tx.permute(0, 3, 1, 2)
    if remat:
        y = torch.utils.checkpoint.checkpoint(blk, xin, True, use_reentrant=False)
    else:
        y = blk(xin, True)
    (y.permute(0, 2, 3, 1) * torch.as_tensor(w)).sum().backward()
    commit_batch_stats(blk)
    commit_batch_stats(blk)             # a second commit applies nothing
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    gsd = flax_to_state_dict({"params": jax.device_get(jg), "batch_stats": jstats})
    for name, p in blk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gsd[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    for name, b in blk.named_buffers():
        np.testing.assert_allclose(b.numpy(), gsd[name], rtol=1e-5, atol=1e-6, err_msg=name)


def test_dropout_keep_rate_and_scale():
    g = tprng.step_generator(0, 0, "t")
    x = torch.ones(200_000)
    y = dropout(x, 0.3, g)
    kept = (y != 0).float().mean().item()
    sigma = math.sqrt(0.7 * 0.3 / x.numel())
    assert abs(kept - 0.7) < 3 * sigma, kept
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.7))
    assert dropout(x, 0.3, None) is x and dropout(x, 0.0, g) is x
    assert not dropout(x, 1.0, g).any()


def test_step_generator_is_a_function_of_seed_step_and_name():
    draw = lambda *a: torch.rand(4, generator=tprng.step_generator(*a))
    assert torch.equal(draw(5, 3, "finetune-dropout"), draw(5, 3, "finetune-dropout"))
    assert not torch.equal(draw(5, 3, "finetune-dropout"), draw(5, 4, "finetune-dropout"))
    assert not torch.equal(draw(5, 3, "finetune-dropout"), draw(6, 3, "finetune-dropout"))
    assert not torch.equal(draw(5, 3, "finetune-dropout"), draw(5, 3, "pretrain-dropout"))
    assert tprng._name_to_int("x") == jprng._name_to_int("x")


# ---- the train and eval steps ----

STEP_LR = dict(pt_lr=1e-2, ft_lr=3e-2, weight_decay=1e-4, grad_clip_value=0.1)


@pytest.fixture(scope="module")
def step_batch():
    rng = np.random.default_rng(11)
    b = example_batch(rng, 2, 2, 64, 16, 50)
    b["mask"][1, 12:] = 0                       # a padded report
    b["valid"][3] = False                       # an invalid aux slot (zero image)
    b["images"][3] = 0.0
    return b


@pytest.mark.parametrize("name,with_indication", [("RAdam", True), ("AdamW", False)])
def test_train_step_equals_jax(name, with_indication, step_batch):
    jm, v0, tm0, _ = tiny_pair()
    v = damped(v0)
    batch = step_batch
    # JAX: make_train_step + build_optimizer, dropout intercepted
    tx = recording(joptim.build_optimizer(name, "finetune", v["params"], **STEP_LR))
    jstate = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx)
    jstep = jsteps.make_train_step(jm, tx, jprng.root_key(0), with_indication=with_indication)
    with nn.intercept_methods(no_dropout):
        jstate, jmetrics = jstep(jstate, batch)
    jgrads = flax_to_state_dict({"params": jax.device_get(jstate.opt_state[1])})
    jnew = flax_to_state_dict({"params": jax.device_get(jstate.params),
                               "batch_stats": jax.device_get(jstate.batch_stats)})
    # the port: the same step, dropout off; gradients read by a hook on the optimizer
    model = copy.deepcopy(tm0)
    load_flax_variables(model, v)
    opt = toptim.build_optimizer(name, "finetune", model, **STEP_LR)
    state = tsteps.TrainState(model, opt)
    seen = {}
    step_fn = opt.step
    opt.step = lambda grads: seen.update({k: g.clone() for k, g in grads.items()
                                          if g is not None}) or step_fn(grads)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = tsteps.make_train_step(model, opt, 0, with_indication=with_indication,
                                     dropout=False)(state, torch_batch(batch))
    assert state.step == 1 and all(p.grad is None for p in model.parameters())
    assert math.isclose(float(metrics["lm"]), float(jmetrics["lm"]), rel_tol=1e-5)
    assert float(metrics["all_loss"]) == float(metrics["lm"])

    # gradients: the unused branch's are zero on both sides
    gmax = max(np.abs(g).max() for g in jgrads.values())
    backbone = [n for n in jgrads if n.startswith("visual_extractor.")]
    for n, want in jgrads.items():
        got = seen[n].numpy() if n in seen else np.zeros_like(want)
        if n in backbone:
            continue
        bound = 1e-3 * (np.abs(want).max() + 1e-3 * gmax)
        assert np.abs(got - want).max() <= bound, n
    diff = np.sqrt(sum(((seen[n].numpy() - jgrads[n]) ** 2).sum() for n in backbone))
    norm = np.sqrt(sum((jgrads[n] ** 2).sum() for n in backbone))
    assert diff <= 3e-2 * norm, diff / norm
    # BN running statistics
    for n, b in model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            assert np.abs(b.numpy() - jnew[n]).max() <= 1e-4 * np.abs(jnew[n]).max(), n
    # updated parameters: JAX's update, moved by at most what the gradient
    # difference moves it
    for n, p in model.named_parameters():
        lr = STEP_LR["ft_lr"] if toptim.param_label(n) == "ft" else STEP_LR["pt_lr"]
        got_g = seen[n].numpy() if n in seen else np.zeros_like(jgrads[n])
        g_err = np.abs(got_g - jgrads[n])
        got, want = p.detach().numpy(), jnew[n]
        slack = 1e-6 * np.abs(want) + 1e-7
        if name == "RAdam":
            # count 1 is not rectified: the update is -lr * (clip(g) + wd * p)
            assert (np.abs(got - want) <= lr * g_err * 1.01 + slack).all(), n
        else:
            # AMSGrad's first update is -lr * u / (|u| + eps): where the
            # gradient difference could flip u's sign (a mathematically zero
            # gradient: a softmax key bias, a bias before a BatchNorm) the two
            # sides may step apart; elsewhere they step alike
            sure = np.abs(jgrads[n]) > 2 * g_err + 1e-5 * gmax
            assert (np.abs(got - want) <= lr * 1e-3 + slack)[sure].all(), n
        assert np.array_equal(got, before[n].numpy()) == np.array_equal(want, before[n].numpy())


def test_eval_step_equals_jax():
    jm, v, tm, batch = tiny_pair()
    jeval = jsteps.make_eval_step(jm, with_indication=True)
    want = jeval(jsteps.create_train_state(v, joptim.build_optimizer(
        "RAdam", "finetune", v["params"], pt_lr=1e-3, ft_lr=1e-3, weight_decay=0.0)), batch)
    model = copy.deepcopy(tm)
    state = tsteps.TrainState(model, toptim.build_optimizer(
        "RAdam", "finetune", model, pt_lr=1e-3, ft_lr=1e-3, weight_decay=0.0))
    got = tsteps.make_eval_step(model, with_indication=True)(state, torch_batch(batch))
    assert sorted(got) == sorted(want) == ["all_loss", "lm"]
    assert math.isclose(float(got["lm"]), float(want["lm"]), rel_tol=1e-5)
    assert all(p.grad is None for p in model.parameters())


def test_dropout_draws_are_a_function_of_seed_and_step():
    """Dropout on: the same (seed, step) gives the same loss, another step
    another loss; BatchNorm's statistics are the step's either way."""
    _, _, tm, batch = tiny_pair()

    def first_loss(step, seed=0):
        model = copy.deepcopy(tm)
        opt = toptim.build_optimizer("RAdam", "finetune", model, pt_lr=1e-3, ft_lr=1e-3,
                                     weight_decay=0.0)
        state = tsteps.TrainState(model, opt, step=step)
        fn = tsteps.make_train_step(model, opt, seed, with_indication=True)
        return float(fn(state, torch_batch(batch))["lm"])

    a, b, c = first_loss(3), first_loss(3), first_loss(4)
    assert a == b and a != c
    assert first_loss(3, seed=1) != a


# ---- the trainer's monitor ----

def _logs(n):
    """val_* improving to epoch 4 then flat below its best (an early stop
    after ``early_stop`` more epochs); test_* and train_lm random."""
    rng = np.random.default_rng(4)
    out = []
    for epoch in range(1, n + 1):
        log = {"train_lm": float(rng.random())}
        for k in ("F1-Radgraph-partial", "chexbert_all_micro_f1", "BLEU_4"):
            log[f"val_{k}"] = 0.1 * epoch if epoch <= 4 else 0.2
            log[f"test_{k}"] = float(rng.choice([0.1, 0.2, 0.3]))
        out.append(log)
    return out


@pytest.mark.parametrize("scheduler,early_stop", [("ReduceLROnPlateau", 3),
                                                  ("StepLR", 100)])
def test_trainer_monitor_equals_jax(tmp_path, scheduler, early_stop):
    """Injected epoch logs through both BaseTrainers: the RCB composite, the
    best records, early stop, the scheduler's scale and the metrics log."""
    argv = ["--trainer.early_stop", str(early_stop), "--trainer.epochs", "12",
            "--trainer.save_period", "1000", "--trainer.async_checkpoint", "false",
            "--optim.lr_scheduler", scheduler, "--optim.step_size", "3",
            "--trainer.ft_lr_monitor_metric", "BLEU_4"]
    logs = _logs(12)
    scales = {"jax": [], "torch": []}

    class J(jtrainer.BaseTrainer):
        def _train_epoch(self, epoch):
            scales["jax"].append(float(self.state.opt_state.hyperparams["lr_scale"]))
            return dict(logs[epoch - 1])

    class T(ttrainer.BaseTrainer):
        def _train_epoch(self, epoch):
            scales["torch"].append(self.state.opt.lr_scale)
            return dict(logs[epoch - 1])

    runs = {}
    for side, config, cls in (("jax", jconfig, J), ("torch", tconfig, T)):
        cfg = config.load_config(None, overrides={"trainer.task": "finetune"},
                                 argv=argv + ["--trainer.result_dir", str(tmp_path / side)])
        if side == "jax":
            params = {"w": jnp.zeros(3)}
            tx = joptim.build_optimizer("RAdam", "finetune", params, pt_lr=1e-3, ft_lr=1e-3,
                                        weight_decay=0.0)
            tr = cls(cfg, None, None, tx, jsteps.create_train_state({"params": params}, tx))
        else:
            m = _Leaves({"w": np.zeros(3, np.float32)})
            state = tsteps.TrainState(m, toptim.build_optimizer(
                "RAdam", "finetune", m, pt_lr=1e-3, ft_lr=1e-3, weight_decay=0.0))
            tr = cls(cfg, None, None, state=state, device="cpu")
        last = tr.train()
        with open(os.path.join(cfg.result_dir, "metrics.jsonl")) as f:
            recs = [{k: v for k, v in json.loads(line).items() if k not in ("ts", "wall_s")}
                    for line in f]
        with open(os.path.join(cfg.result_dir, "mimic_cxr_finetune_results_record.csv")) as f:
            record = [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]
        runs[side] = (last, tr.mnt_best, tr.best_recorder, recs, record)
    assert runs["torch"] == runs["jax"]
    assert scales["torch"] == scales["jax"]
    if early_stop == 3:
        assert len(scales["jax"]) == 8          # best at epoch 4, then 4 epochs without
    else:
        assert scales["jax"][-1] == 0.5 ** 3    # StepLR(3, 0.5) after epoch 9


# ---- checkpoints ----

def _small_state(dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    m = ProjectionHead(8, 12, 6, final_bn=True, dtype=dtype)
    for p in m.parameters():
        torch.nn.init.normal_(p.data)
    opt = toptim.build_optimizer("AdamW", "finetune", m, pt_lr=1e-2, ft_lr=1e-2,
                                 weight_decay=1e-3)
    return tsteps.TrainState(m, opt)


def _run(state, steps, seed=1):
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        x = torch.randn(5, 3, 8, generator=g)
        state.model(x, train=True).float().square().mean().backward()
        commit_batch_stats(state.model)
        state.opt.step({n: p.grad for n, p in state.model.named_parameters()})
        state.model.zero_grad(set_to_none=True)
        state.step += 1


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for part in ("params", "buffers"):
        assert sa[part].keys() == sb[part].keys()
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    oa, ob = sa["opt"], sb["opt"]
    assert {k: v for k, v in oa.items() if not isinstance(v, dict)} == \
        {k: v for k, v in ob.items() if not isinstance(v, dict)}
    for slot in ("mu", "nu", "nu_max"):
        for k in oa[slot]:
            assert torch.equal(oa[slot][k], ob[slot][k]), (slot, k)
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("async_save", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip(tmp_path, async_save, dtype):
    state = _small_state(dtype)
    _run(state, 3)
    ckpt = tcheckpoint.CheckpointManager(str(tmp_path / "ck"), async_save=async_save)
    ckpt.save("current", state, {"epoch": 3, "monitor_best": 0.5})
    _run(state, 1)                       # training goes on while the save is written
    fresh = _small_state(dtype, seed=7)
    meta = ckpt.restore("current", fresh)
    assert meta == {"epoch": 3, "monitor_best": 0.5}
    _run(fresh, 1)
    _assert_same_state(fresh, state)
    if dtype == torch.bfloat16:          # the masters keep what bf16 params cannot
        m = fresh.opt.masters()
        assert any(not torch.equal(m[n], p.float()) for n, p in
                   fresh.model.named_parameters() if p.dtype == torch.bfloat16)


def test_checkpoint_best_and_current_slots(tmp_path):
    state = _small_state()
    _run(state, 2)
    ckpt = tcheckpoint.CheckpointManager(str(tmp_path), async_save=True)
    assert not ckpt.exists("current")
    ckpt.save(("current", "best"), state, {"epoch": 2})
    _run(state, 1)
    ckpt.save("current", state, {"epoch": 3})
    ckpt.wait()
    assert ckpt.exists("current") and ckpt.exists("best")
    assert sorted(os.listdir(tmp_path)) == ["best", "best.meta.json", "current",
                                           "current.meta.json"]
    assert not any(f.endswith(".tmp") for d in ("best", "current")
                   for f in os.listdir(tmp_path / d))
    best, cur = _small_state(seed=3), _small_state(seed=4)
    assert ckpt.restore("best", best) == {"epoch": 2}
    assert ckpt.restore("current", cur) == {"epoch": 3}
    assert best.step == 2 and cur.step == 3
    _assert_same_state(cur, state)


def test_checkpoint_wait_raises_a_failed_async_save(tmp_path):
    ckpt = tcheckpoint.CheckpointManager(str(tmp_path), async_save=True)
    (tmp_path / "current").write_text("a file where the slot directory goes")
    ckpt.save("current", _small_state())
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.wait()                          # raised once


def test_partial_load_from_a_saved_slot(tmp_path):
    """``--trainer.load <dir>/checkpoint/best``: name-and-shape matches load
    into the model and the optimizer's float32 masters."""
    src = _small_state()
    _run(src, 2)
    ckpt = tcheckpoint.CheckpointManager(str(tmp_path))
    ckpt.save("best", src)
    model = ProjectionHead(8, 12, 4, final_bn=True, dtype=torch.bfloat16)
    dst = tsteps.TrainState(model, toptim.build_optimizer(
        "RAdam", "finetune", model, pt_lr=1e-3, ft_lr=1e-3, weight_decay=0.0))
    report = tcheckpoint.partial_restore_from(str(tmp_path / "best"), dst.model, dst.opt)
    source = tcheckpoint.load_source(str(tmp_path / "best"))
    target = dst.model.state_dict()
    same = [n for n, t in target.items() if n in source and source[n].shape == t.shape]
    assert report == {"loaded": len(same), "missing": len(set(target) - set(source)),
                      "skipped": len(source) - len(same)}
    assert 0 < len(same) < len(target)
    src_sd = src.state_dict()
    loaded = {**src_sd["params"], **src_sd["buffers"]}
    masters = dst.opt.masters()
    for n in same:
        assert torch.equal(dst.model.state_dict()[n], loaded[n].to(target[n].dtype)), n
        if n in masters:
            assert torch.equal(masters[n], loaded[n]), n


# ---- the finetune CLI: files, resume, refusals ----

TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.d_model", "32",
    "--model.d_ff", "64", "--model.num_heads", "2", "--model.num_layers", "1",
    "--model.rm_num_slots", "2", "--model.rm_d_model", "32",
    "--model.fusion_num_heads", "2", "--model.fusion_intermediate_size", "64",
    "--model.image_size", "32", "--data.max_seq_len", "16",
    "--data.batch_size", "2", "--data.num_workers", "2",
    "--trainer.epochs", "1", "--trainer.log_interval", "1",
    "--decode.beam_size", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
]

# what the JAX package's finetune CLI writes with these arguments over 2 epochs
# (evoke_tpu/train/trainer.py: BaseTrainer, FinetuneTrainer; its checkpoint
# slots hold orbax trees where the port's hold state.pt)
JAX_FILES = ["checkpoint", "config.json", "finetune.log", "metrics.jsonl",
             "mimic_cxr_finetune_results_record.csv", "test_prediction.csv",
             "val_prediction.csv"]
NLG = ["BLEU_1", "BLEU_2", "BLEU_3", "BLEU_4", "METEOR", "ROUGE_L", "CIDer"]
JAX_EPOCH_KEYS = (["ts", "event", "epoch", "train_all_loss", "train_lm"]
                  + [f"{s}_{k}" for s in ("val", "test") for k in NLG] + ["wall_s"])
JAX_RECORD_COLUMNS = ["val_RCB", "time", "seed", "best_model_from", "version"]


@pytest.fixture(scope="module")
def finetune_runs(tmp_path_factory):
    """The port's finetune CLI at TINY on the CPU: 2 epochs straight, and 1
    epoch then ``--trainer.resume auto`` for the second."""
    root = str(tmp_path_factory.mktemp("finetune"))
    ann = write_synthetic_dataset(root, n_train=6, n_val=2, n_test=3, image_size=32, seed=3)

    def common(res):
        return (["--data.ann_path", ann, "--data.image_dir", root,
                 "--data.tokenizer_dir", os.path.join(root, "tok"),
                 "--trainer.result_dir", os.path.join(root, res)] + TINY)

    assert tcli.main(["finetune", "--device", "cpu"] + common("straight")
                     + ["--trainer.epochs", "2"]) == 0
    assert tcli.main(["finetune", "--device", "cpu", "--trainer.resume", "auto"]
                     + common("resumed")) == 0
    assert tcli.main(["finetune", "--device", "cpu", "--trainer.resume", "auto"]
                     + common("resumed") + ["--trainer.epochs", "2"]) == 0
    sub = os.path.join("mimic_cxr", "finetune", "v1")
    return dict(root=root, ann=ann, common=common,
                straight=os.path.join(root, "straight", sub),
                resumed=os.path.join(root, "resumed", sub))


def _epochs(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_finetune_cli_writes_what_jax_writes(finetune_runs):
    d = finetune_runs["resumed"]
    assert sorted(os.listdir(d)) == JAX_FILES
    assert sorted(os.listdir(os.path.join(d, "checkpoint"))) == ["current",
                                                                 "current.meta.json"]
    recs = _epochs(d)
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(list(r) == JAX_EPOCH_KEYS for r in recs)
    for split in ("val", "test"):
        with open(os.path.join(d, f"{split}_prediction.csv"), newline="") as f:
            rows = list(csv.reader(f))
        assert rows[0] == ["images_id", "ground_truth", "pred_1", "pred_2"]
        # epoch 2's column merged in as pandas' outer merge does: keys sorted
        assert [r[1] for r in rows[1:8]] == sorted(NLG)
        assert all(r[0] == f"__metric__{r[1]}" for r in rows[1:8])
    with open(os.path.join(d, "mimic_cxr_finetune_results_record.csv"), newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == JAX_RECORD_COLUMNS and len(rows) == 1 + 4
    with open(os.path.join(d, "checkpoint", "current.meta.json")) as f:
        assert json.load(f) == {"epoch": 2, "monitor_best": -math.inf,
                                "scheduler": {"scale": 1.0, "best": None, "bad_epochs": 0}}
    # config.json: byte for byte what the JAX CLI saves for the same arguments
    argv = finetune_runs["common"]("resumed") + ["--trainer.epochs", "2",
                                                 "--trainer.resume", "auto"]
    jc = jconfig.load_config(None, overrides={"trainer.task": "finetune"}, argv=argv)
    jc.vocab_size = json.load(open(os.path.join(d, "config.json")))["vocab_size"]
    jc.save(os.path.join(finetune_runs["root"], "jax_config.json"))
    assert open(os.path.join(d, "config.json"), "rb").read() == \
        open(os.path.join(finetune_runs["root"], "jax_config.json"), "rb").read()
    log = open(os.path.join(d, "finetune.log")).read()
    assert "resume=auto: no checkpoint yet, starting fresh" in log
    assert "resumed from current: epoch 2" in log


def test_resume_is_bit_equal_to_an_unbroken_run(finetune_runs):
    a = torch.load(os.path.join(finetune_runs["straight"], "checkpoint", "current",
                                "state.pt"), weights_only=True)
    b = torch.load(os.path.join(finetune_runs["resumed"], "checkpoint", "current",
                                "state.pt"), weights_only=True)
    assert a["step"] == b["step"] > 0
    for part in ("params", "buffers"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    assert a["opt"]["count"] == b["opt"]["count"] == a["step"]
    for slot in ("mu", "nu"):
        assert all(torch.equal(a["opt"][slot][k], b["opt"][slot][k]) for k in a["opt"][slot])
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "wall_s")}
                          for r in recs]
    assert strip(_epochs(finetune_runs["straight"])) == strip(_epochs(finetune_runs["resumed"]))
    steps = lambda d: [line.split("|", 1)[1] for line in open(os.path.join(d, "finetune.log"))
                       if " step " in line]
    assert steps(finetune_runs["straight"]) == steps(finetune_runs["resumed"])


def test_finetune_cli_refusals(finetune_runs, monkeypatch):
    common = finetune_runs["common"]("refused")
    with pytest.raises(ValueError, match="optim.optim='Radam'"):
        tcli.main(["finetune", "--device", "cpu", "--optim.optim", "Radam"] + common)
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcli.main(["pretrain", "--device", "cpu", "--loss.pretrain_los", "mpc"] + common)
    with pytest.raises(FileNotFoundError):
        tcli.main(["finetune", "--device", "cpu", "--trainer.resume", "best"] + common)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["finetune"] + common)
