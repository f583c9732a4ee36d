"""Port parity: stage-1 pretraining (losses/contrastive.py, models/pretrain.py,
the pretrain train and eval steps, PretrainTrainer, ``cli pretrain``, the
cross-stage load into the finetune model), each against its JAX counterpart
on the same numpy-seeded inputs, on the CPU at float32.

Dropout is off on both sides of a parity step (JAX's through
``flax.linen.intercept_methods``, the port's by ``dropout=False``), as in
tests/test_torch_port_train.py.

Tolerances, and why:

- Each loss: 1e-6 relative (float32 sums of a few dozen terms in another
  order); its input gradients 1e-5 of the largest.
- The model's forward (every ``pretrain_loss``, both multi-positive
  formulations, multiview learning off): each loss 1e-5 relative (a
  ResNet-101 forward in float32 in another summation order).
- One train step: tests/test_torch_port_train.py's tolerances: the loss
  1e-5 relative; BatchNorm's running statistics 1e-4 of the leaf's largest;
  gradients outside the ResNet 1e-3 of (the leaf's largest + 1e-3 of the
  largest gradient); the ResNet's 3e-2 in L2 norm relative; updated
  parameters within the gradient difference times the learning rate, plus
  1e-6 relative.
- The ResNet block by block in training mode (each stage's first block and
  one later block, the same input on both sides): output, input and weight
  gradients and running statistics each at 1e-5 in L2 norm relative, the
  whole step's ResNet measure (3e-2) taken block by block.
- The eval step: each loss 1e-5 relative.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
import flax.linen as nn
import jax
import jax.numpy as jnp

from evoke_tpu.core import checkpoint as jcheckpoint
from evoke_tpu.core import config as jconfig
from evoke_tpu.core import prng as jprng
from evoke_tpu.losses import contrastive as jloss
from evoke_tpu.models.finetune import FinetuneModel as JFinetune
from evoke_tpu.models.pretrain import PretrainModel as JPretrain
from evoke_tpu.models.resnet import Bottleneck as JBottleneck
from evoke_tpu.train import optim as joptim
from evoke_tpu.train import steps as jsteps
from evoke_tpu_torch import cli as tcli
from evoke_tpu_torch.core import checkpoint as tcheckpoint
from evoke_tpu_torch.data.synthetic import write_synthetic_dataset
from evoke_tpu_torch.losses import contrastive as tloss
from evoke_tpu_torch.models.finetune import FinetuneModel as TFinetune
from evoke_tpu_torch.models.layers import commit_batch_stats
from evoke_tpu_torch.models.pretrain import PretrainModel as TPretrain
from evoke_tpu_torch.models.resnet import Bottleneck as TBottleneck
from evoke_tpu_torch.params import flax_to_state_dict, load_flax_variables
from evoke_tpu_torch.train import optim as toptim
from evoke_tpu_torch.train import steps as tsteps

from _torch_port_util import TINY, damped, example_batch, no_dropout, recording, torch_batch

torch.set_num_threads(2)

# the pretrain model's share of the port's TINY test dims
PRETRAIN_TINY = {k: TINY[k] for k in ("output_dim", "encoder_hidden_size",
                                       "encoder_num_layers", "encoder_num_heads",
                                       "encoder_intermediate_size", "fusion_wide_qkv")}
VOCAB = 50


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---- the losses ----

def _loss_inputs(case):
    """B 6 images (studies 0, 0, 1, 2, 2, 3: four with a partner), D 16, T 5
    tokens, P 4 patches; ``padded``: the last two rows invalid and text pads;
    ``no_partners``: every image its own study."""
    rng = np.random.default_rng(7)
    pids = np.array([0, 0, 1, 2, 2, 3], np.int32)
    valid = np.ones(6, bool)
    mask = np.ones((6, 5), np.int32)
    if case == "padded":
        valid[4:] = False
        mask[1, 3:] = 0
        mask[2, 1:] = 0
    if case == "no_partners":
        pids = np.arange(6, dtype=np.int32)
    return dict(img=rng.normal(size=(6, 16)).astype(np.float32),
                txt=rng.normal(size=(6, 16)).astype(np.float32),
                patches=rng.normal(size=(6, 4, 16)).astype(np.float32),
                tokens=rng.normal(size=(6, 5, 16)).astype(np.float32),
                pids=pids, valid=valid, mask=mask)


LOSSES = {
    "multi_positive": (lambda m, x, y, a: m.multi_positive_image_loss(x, a["pids"], a["valid"],
                                                                       0.5), "img", None),
    "multi_positive_avg": (lambda m, x, y, a: m.multi_positive_image_loss_avg(
        x, a["pids"], a["valid"], 0.5), "img", None),
    "global": (lambda m, x, y, a: m.global_alignment_loss(x, y, a["pids"], a["valid"], 0.3),
               "img", "txt"),
    "local": (lambda m, x, y, a: m.local_token_alignment_loss(x, y, a["mask"], 0.5,
                                                              valid=a["valid"]),
              "patches", "tokens"),
    "local_no_mask": (lambda m, x, y, a: m.local_token_alignment_loss(x, y, None, 0.5,
                                                                      valid=a["valid"]),
                      "patches", "tokens"),
}


@pytest.mark.parametrize("case", ["plain", "padded", "no_partners"])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_equals_jax(name, case):
    fn, xa, ya = LOSSES[name]
    a = _loss_inputs(case)
    args = [a[xa]] + ([a[ya]] if ya else [])
    jargs = {k: jnp.asarray(v) for k, v in a.items()}
    jf = lambda *xs: fn(jloss, xs[0], xs[1] if len(xs) > 1 else None, jargs)
    want, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(args))))(
        *[jnp.asarray(x) for x in args])
    targs = {k: _t(v) for k, v in a.items()}
    xs = [_t(x).requires_grad_(True) for x in args]
    got = fn(tloss, xs[0], xs[1] if len(xs) > 1 else None, targs)
    assert got.dtype == torch.float32
    if case == "no_partners" and name.startswith("multi_positive"):
        assert got.item() == float(want) == 0.0
    else:
        assert math.isclose(got.item(), float(want), rel_tol=1e-6), (got.item(), float(want))
    got.backward()
    for x, jg in zip(xs, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * max(np.abs(jg).max(), 1e-30))


def test_losses_cast_bf16_inputs_to_float32():
    """bf16 embeddings are cast to float32 first: the loss equals the float32
    loss of the bf16-rounded values."""
    a = _loss_inputs("plain")
    x = _t(a["img"]).bfloat16()
    got = tloss.multi_positive_image_loss(x, _t(a["pids"]), _t(a["valid"]), 0.5)
    want = tloss.multi_positive_image_loss(x.float(), _t(a["pids"]), _t(a["valid"]), 0.5)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---- the model ----

@pytest.fixture(scope="module")
def pretrain_pair():
    """(JAX model, its float32 variables as numpy, batch): the TINY pretrain
    model at 64 px (4 patches), 3 anchors + 3 aux views, one aux slot
    invalid, padded keyword texts."""
    rng = np.random.default_rng(5)
    b = example_batch(rng, 3, 3, 64, 12, VOCAB)
    b["mask"][0, 9:] = 0
    b["mask"][2, 5:] = 0
    b["ids"] = np.where(b["mask"] == 1, b["ids"], 0).astype(np.int32)
    b["valid"][5] = False
    b["images"][5] = 0.0
    jm = JPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
    v = jax.jit(jm.init)(jax.random.key(0), b["images"], b["ids"], b["mask"], b["pids"],
                         b["valid"])
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    return jm, v, b


def _for_model(jm, v, b):
    """``v`` cut to the variables flax creates for ``jm`` (its init's tree,
    shapes only)."""
    shapes = jax.eval_shape(jm.init, jax.random.key(0), b["images"], b["ids"], b["mask"],
                            b["pids"], b["valid"])

    def cut(tree, ref):
        return {k: cut(tree[k], r) if isinstance(r, dict) else tree[k] for k, r in ref.items()}

    return {col: cut(v[col], dict(shapes[col])) for col in shapes}


CONFIGS = [dict(pretrain_loss=loss) for loss in
           ("all", "mpc", "mpc+global", "mpc+local", "global+local")]
CONFIGS += [dict(mul_pos_formulation="avg"), dict(is_multiview_learning=False),
            dict(mask_local_pad=False)]


@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_forward_equals_jax(pretrain_pair, kw):
    """The eval forward of each configuration; the port builds exactly the
    modules flax creates for it (load_flax_variables: no missing or unused
    key)."""
    _, v, b = pretrain_pair
    jm = JPretrain(vocab_size=VOCAB, **PRETRAIN_TINY, **kw)
    want = jm.apply(v, b["images"], b["ids"], b["mask"], b["pids"], b["valid"])
    tm = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY, **kw)
    load_flax_variables(tm, _for_model(jm, v, b))
    with torch.no_grad():
        got = tm(*[_t(b[k]) for k in ("images", "ids", "mask", "pids", "valid")])
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert math.isclose(float(got[k]), float(want[k]), rel_tol=1e-5, abs_tol=1e-7), k
    if kw.get("pretrain_loss") == "mpc":
        assert not hasattr(tm, "text_encoder") and float(got["instance_loss"]) == 0.0
    if kw.get("pretrain_loss") == "global+local":
        assert float(got["multiview_loss"]) == 0.0


def test_refuses_an_unknown_loss_name():
    with pytest.raises(ValueError, match="pretrain_loss"):
        TPretrain(vocab_size=VOCAB, pretrain_loss="mcp", **PRETRAIN_TINY)


def test_encode_images_equals_jax(pretrain_pair):
    jm, v, b = pretrain_pair
    want = jm.apply(v, b["images"], b["pids"], b["valid"], 3, method=jm.encode_images)
    tm = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
    load_flax_variables(tm, v)
    with torch.no_grad():
        got = tm.encode_images(_t(b["images"]), _t(b["pids"]), _t(b["valid"]), 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert tuple(got[0].shape) == (3, 1 + 4, PRETRAIN_TINY["output_dim"])


# ---- the train and eval steps ----

STEP_LR = dict(pt_lr=1e-2, ft_lr=1e-2, weight_decay=1e-4, grad_clip_value=0.1)


@pytest.mark.parametrize("name,kw", [("RAdam", dict()),
                                     ("AdamW", dict(pretrain_loss="global+local",
                                                    mul_pos_formulation="avg"))],
                         ids=["RAdam-all-soft", "AdamW-global+local-avg"])
def test_train_step_equals_jax(pretrain_pair, name, kw):
    _, v0, b = pretrain_pair
    v = damped(v0)
    jm = JPretrain(vocab_size=VOCAB, **PRETRAIN_TINY, **kw)
    v = _for_model(jm, v, b)
    tx = recording(joptim.build_optimizer(name, "pretrain", v["params"], **STEP_LR))
    jstate = jsteps.create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx)
    jstep = jsteps.make_train_step(jm, tx, jprng.root_key(0), task="pretrain")
    with nn.intercept_methods(no_dropout):
        jstate, jmetrics = jstep(jstate, b)
    jgrads = flax_to_state_dict({"params": jax.device_get(jstate.opt_state[1])})
    jnew = flax_to_state_dict({"params": jax.device_get(jstate.params),
                               "batch_stats": jax.device_get(jstate.batch_stats)})

    model = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY, **kw)
    load_flax_variables(model, v)
    opt = toptim.build_optimizer(name, "pretrain", model, **STEP_LR)
    assert list(opt.groups) == ["pt"]
    state = tsteps.TrainState(model, opt)
    seen = {}
    step_fn = opt.step
    opt.step = lambda grads: seen.update({k: g.clone() for k, g in grads.items()
                                          if g is not None}) or step_fn(grads)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = tsteps.make_train_step(model, opt, 0, task="pretrain", dropout=False)(
        state, torch_batch(b))
    assert state.step == 1 and sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        assert math.isclose(float(metrics[k]), float(jmetrics[k]), rel_tol=1e-5,
                            abs_tol=1e-7), k

    gmax = max(np.abs(g).max() for g in jgrads.values())
    backbone = [n for n in jgrads if n.startswith("visual_extractor.")]
    for n, want in jgrads.items():
        if n in backbone:
            continue
        got = seen[n].numpy() if n in seen else np.zeros_like(want)
        assert np.abs(got - want).max() <= 1e-3 * (np.abs(want).max() + 1e-3 * gmax), n
    diff = np.sqrt(sum(((seen[n].numpy() - jgrads[n]) ** 2).sum() for n in backbone))
    norm = np.sqrt(sum((jgrads[n] ** 2).sum() for n in backbone))
    assert diff <= 3e-2 * norm, diff / norm
    for n, t in model.state_dict().items():
        if n.endswith(("running_mean", "running_var")):
            assert np.abs(t.numpy() - jnew[n]).max() <= 1e-4 * np.abs(jnew[n]).max(), n
    lr = STEP_LR["pt_lr"]
    for n, p in model.named_parameters():
        got_g = seen[n].numpy() if n in seen else np.zeros_like(jgrads[n])
        g_err = np.abs(got_g - jgrads[n])
        got, want = p.detach().numpy(), jnew[n]
        slack = 1e-6 * np.abs(want) + 1e-7
        if name == "RAdam":
            assert (np.abs(got - want) <= lr * g_err * 1.01 + slack).all(), n
        else:
            # AMSGrad's first update is -lr * u / (|u| + eps), u the gradient
            # plus the weight decay term: where the gradient difference could
            # flip u's sign the sides may step apart
            u = jgrads[n] + STEP_LR["weight_decay"] * before[n].numpy()
            sure = np.abs(u) > 2 * g_err + 1e-5 * gmax
            assert (np.abs(got - want) <= lr * 1e-3 + slack)[sure].all(), n
        assert np.array_equal(got, before[n].numpy()) == np.array_equal(want, before[n].numpy())


def test_eval_step_equals_jax(pretrain_pair):
    jm, v, b = pretrain_pair
    tx = joptim.build_optimizer("RAdam", "pretrain", v["params"], **STEP_LR)
    want = jsteps.make_eval_step(jm)(jsteps.create_train_state(v, tx), b)
    model = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
    load_flax_variables(model, v)
    state = tsteps.TrainState(model, toptim.build_optimizer("RAdam", "pretrain", model,
                                                            **STEP_LR))
    images_u8 = dict(b, images=np.clip(b["images"] * 40 + 128, 0, 255).astype(np.uint8))
    got = tsteps.make_eval_step(model)(state, torch_batch(b))
    assert sorted(got) == sorted(want)
    for k in want:
        assert math.isclose(float(got[k]), float(want[k]), rel_tol=1e-5, abs_tol=1e-7), k
    # uint8 images are normalised on the device as JAX's maybe_normalize_images does
    want8 = jsteps.make_eval_step(jm)(jsteps.create_train_state(v, tx), images_u8)
    got8 = tsteps.make_eval_step(model)(state, torch_batch(images_u8))
    assert math.isclose(float(got8["all_loss"]), float(want8["all_loss"]), rel_tol=1e-5)
    assert all(p.grad is None for p in model.parameters())


def test_dropout_draws_follow_the_step(pretrain_pair):
    """Dropout on (text encoder and fusion attention): the same (seed, step)
    gives the same loss, another step another loss."""
    _, v, b = pretrain_pair

    def first_loss(step):
        model = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
        load_flax_variables(model, v)
        opt = toptim.build_optimizer("RAdam", "pretrain", model, **STEP_LR)
        fn = tsteps.make_train_step(model, opt, 0, task="pretrain")
        return float(fn(tsteps.TrainState(model, opt, step=step), torch_batch(b))["all_loss"])

    a, again, other = first_loss(3), first_loss(3), first_loss(4)
    assert a == again and a != other


# ---- the ResNet block by block in training mode ----

# (stage, block): each stage's first (projecting, strided) block and a later one
BLOCKS = [(1, 0), (1, 2), (2, 0), (2, 3), (3, 0), (3, 22), (4, 0), (4, 2)]


@pytest.mark.parametrize("stage,block", BLOCKS, ids=[f"layer{s}_{i}" for s, i in BLOCKS])
def test_resnet_block_train_mode_equals_jax(pretrain_pair, stage, block):
    """One Bottleneck of the pretrain model's ResNet-101 (its initialised
    weights and statistics) in training mode, the same input on both sides:
    output, input and weight gradients and running statistics, each at 1e-5
    in L2 norm relative."""
    _, v, _ = pretrain_pair
    name = f"layer{stage}_{block}"
    features = 64 * 2 ** (stage - 1)
    project, stride = block == 0, (2 if stage > 1 and block == 0 else 1)
    cin = features * 4 if block > 0 else (64 if stage == 1 else features * 2)
    size = 8 if stride == 2 else 4
    rng = np.random.default_rng(stage * 10 + block)
    x = np.abs(rng.normal(size=(4, size, size, cin))).astype(np.float32)
    out = size // stride
    w = rng.normal(size=(4, out, out, features * 4)).astype(np.float32)
    bv = {"params": v["params"]["visual_extractor"]["backbone"][name],
          "batch_stats": v["batch_stats"]["visual_extractor"]["backbone"][name]}
    jblk = JBottleneck(features, stride=stride, project=project)

    def jf(params, x):
        y, mut = jblk.apply({"params": params, "batch_stats": bv["batch_stats"]}, x, True,
                            mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        bv["params"], x)
    blk = TBottleneck(cin, features, stride=stride, project=project)
    load_flax_variables(blk, bv)
    tx = torch.as_tensor(x).requires_grad_(True)
    y = blk(tx.permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
    (y * torch.as_tensor(w)).sum().backward()
    commit_batch_stats(blk)

    def close(got, want, what):
        want = np.asarray(want)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, (what, rel)

    close(y.detach().numpy(), jy, "output")
    close(tx.grad.numpy(), jgx, "input gradient")
    gsd = flax_to_state_dict({"params": jax.device_get(jg), "batch_stats": jstats})
    for n, p in blk.named_parameters():
        close(p.grad.numpy(), gsd[n], n)
    for n, t in blk.named_buffers():
        close(t.numpy(), gsd[n], n)


# ---- the cross-stage load ----

def test_partial_load_into_finetune_loads_what_jax_loads(pretrain_pair, tmp_path):
    """A pretrain slot into the finetune model: the parameters the port loads
    are JAX's ``partial_restore`` (by count, and value for value), the
    visual extractor, text encoder, fusion and heads' layers among them; the
    finetune heads' final BatchNorm and every other finetune-only entry keep
    their init. The port also carries the BatchNorm statistics of the shared
    modules (the reference's ``load_state_dict(strict=False)`` does; JAX's
    partial restore reads the params tree alone)."""
    _, v, b = pretrain_pair
    jf = JFinetune(vocab_size=VOCAB, **TINY)
    fb = dict(b, inc_ids=b["ids"], inc_mask=b["mask"])
    fv = jax.jit(lambda *a: jf.init(*a, method=jf.warmup))(
        jax.random.key(1), fb["images"], fb["ids"], fb["mask"], fb["pids"], fb["valid"],
        fb["inc_ids"], fb["inc_mask"])
    fv = jax.tree_util.tree_map(np.asarray, jax.device_get(fv))
    merged, report = jcheckpoint.CheckpointManager(str(tmp_path / "j")).partial_restore(
        v["params"], fv["params"])

    model = TPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
    load_flax_variables(model, v)
    state = tsteps.TrainState(model, toptim.build_optimizer("RAdam", "pretrain", model,
                                                            **STEP_LR))
    tcheckpoint.CheckpointManager(str(tmp_path / "t")).save("current", state, {"epoch": 1})
    ft = TFinetune(vocab_size=VOCAB, **TINY)
    load_flax_variables(ft, fv)
    opt = toptim.build_optimizer("RAdam", "finetune", ft, **STEP_LR)
    got = tcheckpoint.partial_restore_from(str(tmp_path / "t" / "current"), ft, opt)
    params = dict(ft.named_parameters())
    source = tcheckpoint.load_source(str(tmp_path / "t" / "current"))
    loaded = [n for n in params if n in source and source[n].shape == params[n].shape]
    assert report == {"loaded": len(loaded), "skipped": len(params) - len(loaded)}
    want = flax_to_state_dict({"params": jax.device_get(merged)})
    for n, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n], err_msg=n)
    masters = opt.masters()
    assert all(torch.equal(masters[n], params[n].detach()) for n in loaded)
    prefixes = {n.split(".")[0] for n in loaded}
    assert prefixes == {"visual_extractor", "text_encoder", "fusion", "visual_head",
                        "text_head"}
    assert not any(n.startswith(("visual_head.SeqBatchNorm_1", "text_head.SeqBatchNorm_1"))
                   for n in ft.state_dict() if n in source)
    buffers = [n for n, _ in ft.named_buffers() if n in source]
    assert got == {"loaded": len(loaded) + len(buffers),
                   "missing": len(set(ft.state_dict()) - set(source)),
                   "skipped": len(source) - len(loaded) - len(buffers)}


# ---- the pretrain CLI: files, resume ----

CLI_TINY = [
    "--model.output_dim", "32", "--model.encoder_hidden_size", "32",
    "--model.encoder_num_hidden_layers", "1", "--model.encoder_num_heads", "2",
    "--model.encoder_intermediate_size", "64", "--model.image_size", "32",
    "--data.max_seq_len", "16", "--data.batch_size", "2", "--data.num_workers", "2",
    "--trainer.log_interval", "1", "--trainer.test_every", "2",
    "--model.fusion_wide_qkv", "false", "--model.proj_num_heads", "2",
]

# what the JAX package's pretrain CLI writes with these arguments over 2
# epochs (evoke_tpu/train/trainer.py: BaseTrainer, PretrainTrainer; its slots
# hold orbax trees where the port's hold state.pt)
JAX_FILES = ["checkpoint", "config.json", "metrics.jsonl",
             "mimic_cxr_pretrain_results_record.csv", "pretrain.log"]
LOSS_KEYS = ["all_loss", "instance_loss", "multiview_loss", "sen_text_loss"]


def _epoch_keys(splits):
    return (["ts", "event", "epoch"] + [f"{s}_{k}" for s in splits for k in LOSS_KEYS]
            + ["wall_s"])


JAX_RECORD_COLUMNS = (["val_all_loss", "epoch"] + [f"train_{k}" for k in LOSS_KEYS]
                      + [f"val_{k}" for k in LOSS_KEYS[1:]]
                      + [f"test_{k}" for k in LOSS_KEYS]
                      + ["time", "seed", "best_model_from", "version"])


@pytest.fixture(scope="module")
def pretrain_runs(tmp_path_factory):
    """The port's pretrain CLI at TINY on the CPU: 2 epochs straight, and 1
    epoch then ``--trainer.resume auto`` for the second."""
    root = str(tmp_path_factory.mktemp("pretrain"))
    ann = write_synthetic_dataset(root, n_train=6, n_val=2, n_test=3, image_size=32, seed=3)

    def common(res):
        return (["--data.ann_path", ann, "--data.image_dir", root,
                 "--data.tokenizer_dir", os.path.join(root, "tok"),
                 "--trainer.result_dir", os.path.join(root, res)] + CLI_TINY)

    assert tcli.main(["pretrain", "--device", "cpu", "--trainer.epochs", "2"]
                     + common("straight")) == 0
    assert tcli.main(["pretrain", "--device", "cpu", "--trainer.resume", "auto",
                      "--trainer.epochs", "1"] + common("resumed")) == 0
    assert tcli.main(["pretrain", "--device", "cpu", "--trainer.resume", "auto",
                      "--trainer.epochs", "2"] + common("resumed")) == 0
    sub = os.path.join("mimic_cxr", "pretrain", "v1")
    return dict(root=root, common=common, straight=os.path.join(root, "straight", sub),
                resumed=os.path.join(root, "resumed", sub))


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_pretrain_cli_writes_what_jax_writes(pretrain_runs):
    d = pretrain_runs["resumed"]
    assert sorted(os.listdir(d)) == JAX_FILES
    assert sorted(os.listdir(os.path.join(d, "checkpoint"))) == [
        "best", "best.meta.json", "current", "current.meta.json"]
    recs = _records(d)
    assert [r["epoch"] for r in recs] == [1, 2]
    assert list(recs[0]) == _epoch_keys(("train", "val"))
    assert list(recs[1]) == _epoch_keys(("train", "val", "test"))   # test_every 2
    assert all(math.isfinite(r[k]) for r in recs for k in r if k.endswith("_loss"))
    record = lambda run: open(os.path.join(pretrain_runs[run],
                                           "mimic_cxr_pretrain_results_record.csv")).read()
    # a row per split and run, the header of the run that made the file
    lines = record("straight").splitlines()
    assert lines[0].split(",") == JAX_RECORD_COLUMNS and len(lines) == 1 + 2
    assert len(record("resumed").splitlines()) == 1 + 4
    with open(os.path.join(d, "checkpoint", "current.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 2 and meta["scheduler"]["bad_epochs"] in (0, 1)
    assert meta["monitor_best"] == min(r["val_all_loss"] for r in recs)
    argv = pretrain_runs["common"]("resumed") + ["--trainer.resume", "auto",
                                                 "--trainer.epochs", "2"]
    jc = jconfig.load_config(None, overrides={"trainer.task": "pretrain"}, argv=argv)
    jc.vocab_size = json.load(open(os.path.join(d, "config.json")))["vocab_size"]
    jc.save(os.path.join(pretrain_runs["root"], "jax_config.json"))
    assert open(os.path.join(d, "config.json"), "rb").read() == \
        open(os.path.join(pretrain_runs["root"], "jax_config.json"), "rb").read()
    log = open(os.path.join(d, "pretrain.log")).read()
    assert "resume=auto: no checkpoint yet, starting fresh" in log
    assert "resumed from current: epoch 2" in log and "all_loss" in log


def test_pretrain_resume_is_bit_equal_to_an_unbroken_run(pretrain_runs):
    a = torch.load(os.path.join(pretrain_runs["straight"], "checkpoint", "current",
                                "state.pt"), weights_only=True)
    b = torch.load(os.path.join(pretrain_runs["resumed"], "checkpoint", "current",
                                "state.pt"), weights_only=True)
    assert a["step"] == b["step"] == 6
    for part in ("params", "buffers"):
        assert a[part].keys() == b[part].keys()
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    for slot in ("mu", "nu"):
        assert all(torch.equal(a["opt"][slot][k], b["opt"][slot][k]) for k in a["opt"][slot])
    strip = lambda recs: [{k: v for k, v in r.items() if k not in ("ts", "wall_s")}
                          for r in recs]
    assert strip(_records(pretrain_runs["straight"])) == strip(_records(pretrain_runs["resumed"]))


def test_pretrain_cli_refusals(pretrain_runs, monkeypatch):
    common = pretrain_runs["common"]("refused")
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcli.main(["pretrain", "--device", "cpu", "--loss.pretrain_los", "mpc"] + common)
    with pytest.raises(ValueError, match="pretrain_loss"):
        tcli.main(["pretrain", "--device", "cpu", "--loss.pretrain_loss", "mcp"] + common)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["pretrain"] + common)
