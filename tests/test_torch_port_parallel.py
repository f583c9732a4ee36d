"""Port parity: the data-parallel mesh (core/mesh.py, parallel/collectives.py,
ops/sharding.py) and the global-batch losses and train steps under it.

Every spawned case runs 2 gloo ranks on the CPU (``evoke_tpu_torch.core.mesh
.spawn``; the rank bodies are in ``_torch_port_dp.py``, which imports no
JAX) with a time limit of its own; the JAX references run here, on the
8 virtual CPU devices of tests/conftest.py, at float32:

- ``shard_batch`` gives each rank the rows JAX's dp shards hold, raises on
  a leading dim that does not divide dp, replicates 0-d leaves and, with
  ``allow_replicate``, odd ones, and slices a tensor already on the rank's
  device in place (tests/test_core.py:50-99);
- ``multi_positive_image_loss`` with every pair split across the ranks,
  through ``make_shardmap_loss``, equals JAX's dp-sharded and one-device
  losses at rtol 1e-5, and its gradient through ``all_gather_batch`` the
  one-process gradient at 1e-6 (tests/test_losses.py:143);
- the finetune and pretrain eval losses at dp=2 equal JAX's sharded
  ``make_eval_step`` at rtol 2e-5 (tests/test_train_steps.py:217); one dp
  train step with dropout on equals the port's one-rank step on the global
  batch within 1e-5 relative (loss, every parameter and BatchNorm
  statistic), and leaves the ranks' parameters bit-identical;
- a rank's ``rank_view`` of a batcher decodes only the rank's image rows
  and keeps the rest of the global batch;
- the kernel policies under a mesh (tests/test_parallel.py:270) and the
  refusals: ``MeshSpec(dp=2, mp=2)`` in a 2-rank group raises ``ValueError``
  (it needs 4 processes), a mesh larger than the visible cards raises
  ``ValueError`` (``spawn``'s default too), and so does an asynchronous
  checkpoint under a mesh;
- ``python -m evoke_tpu_torch.dryrun 2 --device cpu`` prints its 5 stages.
"""

import copy
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evoke_tpu.core import mesh as jmesh
from evoke_tpu.losses.contrastive import multi_positive_image_loss as jmp_loss
from evoke_tpu.models.pretrain import PretrainModel as JPretrain
from evoke_tpu.parallel.collectives import make_shardmap_loss as jshardmap_loss
from evoke_tpu.train import optim as joptim
from evoke_tpu.train import steps as jsteps
from evoke_tpu_torch.core import mesh as tmesh
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.losses.contrastive import multi_positive_image_loss as tmp_loss
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.models.pretrain import PretrainModel
from evoke_tpu_torch.ops.fused_logit_topk import use_fused_logit_topk
from evoke_tpu_torch.ops.sharding import dp_size, mesh_allows_kernels
from evoke_tpu_torch.params import load_flax_variables
from evoke_tpu_torch.train.optim import param_label
from evoke_tpu_torch.train.steps import resolve_beam_kv

import _torch_port_dp as dpcase
from _torch_port_util import TINY, damped, example_batch, tiny_pair, to_np, torch_batch

torch.set_num_threads(2)
VOCAB = 50
PRETRAIN_TINY = {k: TINY[k] for k in ("output_dim", "encoder_hidden_size",
                                      "encoder_num_layers", "encoder_num_heads",
                                      "encoder_intermediate_size", "fusion_wide_qkv")}


def _rank_mesh(rank, dp=2):
    """A rank's mesh without a process group (shard_batch needs none)."""
    return tmesh.Mesh(dp=dp, mp=1, rank=rank, world_size=dp, device=torch.device("cpu"))


# ---- (a) shard_batch ----

def test_shard_batch_gives_each_rank_jax_dp_shard(devices):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    jx = jmesh.shard_batch({"x": x}, jmesh.create_mesh(jmesh.MeshSpec(dp=2)))["x"]
    shards = sorted(jx.addressable_shards, key=lambda s: s.index[0].start)
    for r in range(2):
        got = tmesh.shard_batch({"x": x, "n": np.float32(3.0), "nested": [x[:, :1]]},
                                _rank_mesh(r))
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(shards[r].data))
        assert got["n"].ndim == 0 and float(got["n"]) == 3.0      # 0-d: replicated
        np.testing.assert_array_equal(got["nested"][0].numpy(), x[8 * r:8 * (r + 1), :1])


def test_shard_batch_refuses_a_leading_dim_that_does_not_divide_dp():
    bad = {"x": np.ones((3, 4), np.float32)}
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        tmesh.shard_batch(bad, _rank_mesh(0))
    rep = tmesh.shard_batch(bad, _rank_mesh(1), allow_replicate=True)   # explicit escape
    assert tuple(rep["x"].shape) == (3, 4)
    with pytest.raises(ValueError, match="divide dp=2"):
        from evoke_tpu_torch.ops.sharding import check_divisible

        check_divisible(3, _rank_mesh(0))


def test_shard_batch_keeps_device_tensors_in_place():
    x = torch.arange(32.0).reshape(8, 4)
    one = tmesh.create_mesh(tmesh.MeshSpec(dp=1), device="cpu")
    assert one.group is None and one.dp == 1
    assert tmesh.shard_batch({"x": x}, one)["x"] is x
    z = tmesh.shard_batch({"x": x}, _rank_mesh(1))["x"]
    assert z.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()   # a view
    torch.testing.assert_close(z, x[4:])


def test_rank_view_decodes_only_the_ranks_image_rows(tmp_path):
    """Under a dp mesh a rank's batcher keeps the global layout (texts, pids,
    flags, host extras, the augmentation draws) and decodes only its own
    image rows, each as the whole batch's."""
    from PIL import Image

    from evoke_tpu_torch.data.batching import MultiviewBatcher, rank_view
    from evoke_tpu_torch.data.datasets import Example
    from evoke_tpu_torch.data.transforms import make_transform

    rng = np.random.default_rng(0)
    exs = []
    for i in range(3):
        paths = [f"s{i}_{j}.png" for j in range(2)]
        for p in paths:
            Image.fromarray(rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)).save(tmp_path / p)
        exs.append(Example(id=f"s{i}", study_key=f"s{i}", anchor_path=paths[0],
                           aux_paths=paths[1:], report=f"r{i}", align_text=f"r{i}"))
    tok = SimpleNamespace(pad_id=0, encode_padded=lambda t, n, add_bos_eos=False:
                          np.full(n, len(t), np.int32))
    b = MultiviewBatcher(exs, tok, make_transform(224, True, output_uint8=True), n_anchor=2,
                         n_aux_slots=2, max_seq_len=8, image_dir=str(tmp_path), shuffle=True,
                         seed=3, num_workers=2)
    assert rank_view(b, None) is b and rank_view(b, tmesh.create_mesh(device="cpu")) is b
    assert rank_view([{}], _rank_mesh(0)) == [{}]
    b.set_epoch(0)
    whole = list(b)
    assert len(whole) == 2 and whole[0]["images"].any(axis=(1, 2, 3)).all()
    for r in range(2):
        b.set_epoch(0)
        view = rank_view(b, _rank_mesh(r))
        got = list(view)
        assert len(view) == len(b) == len(got)
        for g, w in zip(got, whole):
            assert sorted(g) == sorted(w)
            for k in w:
                if k != "images":
                    np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), k)
            own = slice(2 * r, 2 * r + 2)
            np.testing.assert_array_equal(g["images"][own], w["images"][own])
            others = np.delete(g["images"], range(2 * r, 2 * r + 2), axis=0)
            assert not others.any()


# ---- (g) the policies and refusals ----

def test_kernel_policies_follow_the_mesh_shape():
    dp_mesh = _rank_mesh(0)
    mp_mesh = SimpleNamespace(shape={"dp": 4, "mp": 2})   # a JAX-shaped dp x mp mesh
    assert mesh_allows_kernels(None) and mesh_allows_kernels(dp_mesh)
    assert not mesh_allows_kernels(mp_mesh)
    assert dp_size(None) == 1 and dp_size(dp_mesh) == 2 and dp_size(mp_mesh) == 4
    auto = SimpleNamespace(beam_kv="auto", kv_cache_dtype="")
    assert resolve_beam_kv(auto, serving=True, mesh=dp_mesh) == "ancestor"
    assert resolve_beam_kv(auto, serving=True, mesh=mp_mesh) == "reorder"
    assert resolve_beam_kv(auto, serving=False, mesh=dp_mesh) == "reorder"
    explicit = SimpleNamespace(beam_kv="ancestor", kv_cache_dtype="")
    assert resolve_beam_kv(explicit, serving=False, mesh=mp_mesh) == "ancestor"
    r2gen = SimpleNamespace(decoder_kind="r2gen")
    assert use_fused_logit_topk(r2gen, True, mesh=dp_mesh)
    assert not use_fused_logit_topk(r2gen, True, mesh=mp_mesh)
    assert not use_fused_logit_topk(r2gen, False, mesh=dp_mesh)
    assert not use_fused_logit_topk(r2gen, True, logits_hook=print)
    assert not use_fused_logit_topk(SimpleNamespace(decoder_kind="cmn"), True)


def test_mesh_refusals(tmp_path, spawned):
    for got in spawned[1]:
        assert got["mp_refusal"] == ("ValueError", "mesh MeshSpec(dp=2, mp=2) needs one "
                                     "process per rank (4): the process group has 2")
    with pytest.raises(ValueError, match="dp must be >= 1"):
        tmesh.MeshSpec(dp=0)
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} devices, have {have}"):
        tmesh.create_mesh(tmesh.MeshSpec(dp=have + 1), device="cuda")
    with pytest.raises(ValueError, match=f"needs {have + 1} devices, have {have}"):
        tmesh.spawn(print, have + 1)             # spawn's ranks default to the cards
    from evoke_tpu_torch.core.checkpoint import CheckpointManager

    with pytest.raises(ValueError, match="async_save under a dp mesh"):
        CheckpointManager(str(tmp_path), async_save=True, mesh=_rank_mesh(0))
    with pytest.raises(ValueError, match="one process per rank"):
        tmesh.create_mesh(tmesh.MeshSpec(dp=2), device="cpu")
    from evoke_tpu_torch.decode.continuous import ContinuousServer

    m = SimpleNamespace(decoder_kind="r2gen")
    with pytest.raises(ValueError, match="decode.slots of 3 rows does not divide dp=2"):
        ContinuousServer(m, SimpleNamespace(unk_id=4), slots=3, mesh=_rank_mesh(0))


# ---- (b), (c): the spawned losses and steps ----

def _finetune_case():
    """tiny_pair's model (bn3 damped) on a 2 + 2 batch of 64 px images (2 x 2
    patches: the batch statistics of the ResNet's last stage take 16 values
    a channel, not 4) whose first anchor has fewer target tokens: rank 0
    holds anchor 0, rank 1 anchor 1 and both aux views (anchor 0's partner
    sits on the other rank)."""
    jm, v, _, _ = tiny_pair(VOCAB)
    v = damped(v)
    b = example_batch(np.random.default_rng(7), 2, 2, 64, 16, VOCAB)
    b["mask"][0, 9:] = 0
    tm = FinetuneModel(vocab_size=VOCAB, dropout=0.1, **TINY).eval()
    load_flax_variables(tm, v)
    return jm, v, tm, b


@pytest.fixture(scope="module")
def pretrain_case():
    rng = np.random.default_rng(5)
    b = example_batch(rng, 2, 2, 64, 12, VOCAB)
    b["mask"][0, 9:] = 0
    b["ids"] = np.where(b["mask"] == 1, b["ids"], 0).astype(np.int32)
    jm = JPretrain(vocab_size=VOCAB, **PRETRAIN_TINY)
    v = damped(to_np(jax.jit(jm.init)(jax.random.key(0), b["images"], b["ids"], b["mask"],
                                      b["pids"], b["valid"])))
    tm = PretrainModel(vocab_size=VOCAB, **PRETRAIN_TINY).eval()
    load_flax_variables(tm, v)
    return jm, v, tm, b


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, pretrain_case):
    """One 2-rank spawn of every (b) / (c) case -> (inputs, [rank0, rank1])."""
    _, _, tm, fb = _finetune_case()
    _, _, pm, pb = pretrain_case
    rng = np.random.default_rng(1)
    n = 16
    embed = rng.normal(size=(n, 8)).astype(np.float32)
    pids = np.concatenate([np.arange(n // 2), np.arange(n // 2)]).astype(np.int32)
    inp = {"dims": dict(TINY, dropout=0.1), "vocab": VOCAB, "finetune_sd": tm.state_dict(),
           "finetune_batch": fb, "pretrain_dims": PRETRAIN_TINY,
           "pretrain_sd": pm.state_dict(), "pretrain_batch": pb,
           "contrastive": (embed, pids, np.ones(n, bool), 0.5)}
    path = str(tmp_path_factory.mktemp("dp_losses") / "inputs.pt")
    torch.save(inp, path)
    return inp, dpcase.spawn_case(dpcase.losses_and_steps, path, timeout_s=240)


def test_contrastive_loss_over_split_pairs_equals_jax(devices, spawned):
    inp, ranks = spawned
    embed, pids, valid, temp = inp["contrastive"]
    single = float(jmp_loss(jnp.asarray(embed), jnp.asarray(pids), jnp.asarray(valid), temp))
    mesh = jmesh.create_mesh(jmesh.MeshSpec(dp=2))
    sb = jmesh.shard_batch({"e": embed, "p": pids, "v": valid}, mesh)
    sharded = float(jax.jit(lambda d: jmp_loss(d["e"], d["p"], d["v"], temp))(sb))
    shardmap = float(jax.jit(jshardmap_loss(mesh, lambda e, p, v: jmp_loss(e, p, v, temp)))(
        sb["e"], sb["p"], sb["v"]))
    e = torch.tensor(embed, requires_grad=True)
    want = tmp_loss(e, torch.as_tensor(pids), torch.as_tensor(valid), temp)
    want.backward()
    for r, got in enumerate(ranks):
        loss, grad = got["contrastive"]
        for ref in (single, sharded, shardmap, want.item()):
            assert math.isclose(loss, ref, rel_tol=1e-5), (r, loss, ref)
    grads = torch.cat([got["contrastive"][1] for got in ranks])
    torch.testing.assert_close(grads, e.grad, rtol=1e-6, atol=1e-6)


def test_eval_losses_at_dp2_equal_jax_sharded_eval_step(devices, spawned, pretrain_case):
    mesh = jmesh.create_mesh(jmesh.MeshSpec(dp=2))
    jm, v, _, fb = _finetune_case()
    tx = joptim.build_optimizer("RAdam", "finetune", v["params"], pt_lr=1e-3, ft_lr=1e-3,
                                weight_decay=0.0)
    want = jsteps.make_eval_step(jm, with_indication=True)(
        jsteps.create_train_state(v, tx), jmesh.shard_batch(fb, mesh))
    pjm, pv, _, pb = pretrain_case
    ptx = joptim.build_optimizer("RAdam", "pretrain", pv["params"], pt_lr=1e-3, ft_lr=1e-3,
                                 weight_decay=0.0)
    pwant = jsteps.make_eval_step(pjm)(jsteps.create_train_state(pv, ptx),
                                       jmesh.shard_batch(pb, mesh))
    for got in spawned[1]:
        assert sorted(got["finetune_eval"]) == sorted(want)
        for k in want:
            assert math.isclose(got["finetune_eval"][k], float(want[k]), rel_tol=2e-5), k
        assert sorted(got["pretrain_eval"]) == sorted(pwant)
        for k in pwant:
            assert math.isclose(got["pretrain_eval"][k], float(pwant[k]), rel_tol=2e-5,
                                abs_tol=1e-7), k


@pytest.mark.parametrize("task", ["finetune", "pretrain"])
def test_dp_train_step_equals_the_global_batch_step(spawned, pretrain_case, task):
    """Dropout on: the dp step's loss, parameters and BatchNorm statistics
    are the port's one-rank step on the global batch (same seed and step),
    and both ranks hold the same parameters bit for bit.

    The updates themselves (RAdam's first step moves a weight by lr times
    its gradient clipped to +-0.1) agree to 1e-3 of the largest step; the
    ResNet's to 2e-2 in L2 norm relative: 33 batch-statistics BatchNorms
    over 4 images amplify the rounding of their statistics' sums (split over
    two ranks here), as they amplify a reordering of the batch's auxiliary
    views on one device (tests/test_torch_port_train.py's bound is 3e-2)."""
    if task == "finetune":
        _, _, model, batch = _finetune_case()
    else:
        _, _, model, batch = pretrain_case
    metrics, after = dpcase.train_once(copy.deepcopy(model), torch_batch(batch), None, task,
                                       with_indication=task == "finetune")
    ranks = [got[f"{task}_train"] for got in spawned[1]]
    for got_metrics, _ in ranks:
        assert sorted(got_metrics) == sorted(metrics)
        for k, want in metrics.items():
            assert math.isclose(got_metrics[k], want, rel_tol=1e-5, abs_tol=1e-7), (k, want)
    before = model.state_dict()
    params = dict(model.named_parameters())
    moved = 0
    for name, want in after.items():
        got0, got1 = ranks[0][1][name], ranks[1][1][name]
        assert torch.equal(got0, got1), name
        moved += not torch.equal(want, before[name])
        # 1e-5 relative; near-zero entries against the tensor's largest, and a
        # parameter's against 1e-3 of the largest step (lr x the clip, 0.1),
        # a ResNet parameter's against the largest step itself
        lr = dpcase.LR["ft_lr" if task == "finetune" and param_label(name) == "ft" else "pt_lr"]
        resnet = name.startswith("visual_extractor")
        step = (1.0 if resnet else 1e-3) * 0.1 * lr if name in params else 0.0
        torch.testing.assert_close(got0, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item() + step + 1e-12)
        if name not in params:
            continue
        err = (got0 - before[name]) - (want - before[name])
        ulp = 2 * torch.finfo(torch.float32).eps * want.abs()     # the step's own rounding
        if resnet:
            assert err.norm() <= 2e-2 * (want - before[name]).norm() + ulp.norm(), name
        else:
            assert (err.abs() <= step + ulp).all(), (name, err.abs().max() / step)
    assert moved > len(after) // 2      # the step moved most of the state


# ---- (h) the dry run ----

def test_dryrun_prints_its_five_stages():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "evoke_tpu_torch.dryrun", "2", "--device", "cpu"],
                         capture_output=True, text=True, timeout=240, cwd=root,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stdout.splitlines() if l.startswith("dryrun(2): ")]
    assert [l.split()[1] for l in lines] == ["train", "decode", "ckpt", "wide-fusion",
                                             "engine"], out.stdout
    assert "8 reports" in lines[-1]
