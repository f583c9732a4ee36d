"""Port parity: tensor parallelism's placement and mesh without spawning
(parallel/tp.py, core/mesh.py), and the dry run at 4 ranks:

- on every leaf of JAX's real flagship tree (``jax.eval_shape``, as
  tests/test_parallel.py:365-399 reads it) the port's ``tp_spec_for_name``
  of the converted name is JAX's ``tp_spec_for_path`` transposed: 101
  column-split, 20 row-split and 581 replicated leaves; the port's flagship,
  built on the meta device (nothing allocated), holds every leaf under that
  name and shape, and ``shard_params_tp`` at mp=2 leaves a rank ~65 % of
  the parameters (the odd-vocab logit stays whole);
- JAX's five spec cases (tests/test_parallel.py:36-47) and the fallback to
  replication of a dim that mp does not divide;
- the rank -> (dp, mp) layout is JAX's ``reshape(dp, mp)``, the kernel
  policies decline mp > 1 (tests/test_parallel.py:272-291), and the
  refusals: a mesh without a process per rank, an unsharded model under an
  mp mesh, captured decoding with mp collectives;
- ``python -m evoke_tpu_torch.dryrun 4 --device cpu`` prints its five
  stages, the first four at dp=2, mp=2.

The spawned cases (gloo ranks) are in test_torch_port_tp_spawn.py.
"""

import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from evoke_tpu.core import mesh as jmesh
from evoke_tpu.parallel.tp import tp_spec_for_path
from evoke_tpu_torch.core import mesh as tmesh
from evoke_tpu_torch.core.config import DecodeConfig
from evoke_tpu_torch.models.finetune import FinetuneModel
from evoke_tpu_torch.ops.fused_logit_topk import use_fused_logit_topk
from evoke_tpu_torch.ops.sharding import mesh_allows_kernels
from evoke_tpu_torch.parallel import tp
from evoke_tpu_torch.params import _PARAM_LEAVES
from evoke_tpu_torch.train.optim import build_optimizer
from evoke_tpu_torch.train.steps import make_generate_step, make_train_step, resolve_beam_kv

from _torch_port_util import TINY, Tok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta_mesh(rank=0, dp=1, mp=2):
    """A rank's view of a dp x mp mesh without a process group."""
    return tmesh.Mesh(dp=dp, mp=mp, rank=rank, world_size=dp * mp,
                      device=torch.device("meta"))


@pytest.fixture(scope="module")
def flagship():
    """JAX's flagship tree (shapes only) and the port's flagship on the meta
    device."""
    spec = importlib.util.spec_from_file_location("graft_entry",
                                                  os.path.join(ROOT, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    model = graft._flagship(vocab_size=30000)
    batch = graft._example_batch(np.random.default_rng(0), 2, 2, 224, 100, 30000)
    shapes = jax.eval_shape(
        lambda k: model.init(k, batch["images"], batch["ids"], batch["mask"], batch["pids"],
                             batch["valid"], batch["inc_ids"], batch["inc_mask"],
                             method=model.warmup), jax.random.key(0))
    return jax.tree_util.tree_flatten_with_path(shapes["params"])[0], _meta_flagship()


def _meta_flagship():
    with torch.device("meta"):
        return FinetuneModel(vocab_size=30000, max_seq_len=100, fusion_max_partners=3,
                             dtype=torch.bfloat16)


def _port_name(path, leaf):
    """A flax parameter path -> (the port's state-dict name, its torch shape)."""
    names = [str(getattr(k, "key", k)) for k in path]
    shape = tuple(leaf.shape)
    if names[-1] == "kernel":
        tname = "weight"
        shape = tuple(reversed(shape)) if len(shape) == 2 else (
            shape[3], shape[2], shape[0], shape[1])
    else:
        tname = _PARAM_LEAVES[names[-1]]
    return ".".join(names[:-1] + [tname]), shape


def test_port_spec_is_jax_spec_on_every_flagship_leaf(flagship):
    leaves, port = flagship
    sd = port.state_dict()
    counts, elements = {}, {}
    for path, leaf in leaves:
        name, shape = _port_name(path, leaf)
        assert tuple(sd[name].shape) == shape, name
        want = tuple(reversed(tuple(tp_spec_for_path(path, leaf))))
        got = tp.tp_spec_for_name(name, sd[name])
        assert got == want, (name, got, want)
        counts[got] = counts.get(got, 0) + 1
        elements[got] = elements.get(got, 0) + int(np.prod(shape))
    assert counts == {tp.COLUMN: 101, tp.ROW: 20, tp.REPLICATED: 581}
    assert elements == {tp.COLUMN: 241_459_712, tp.ROW: 52_297_728,
                        tp.REPLICATED: 104_652_657}


def test_a_rank_holds_two_thirds_of_the_flagship_at_mp2():
    port = _meta_flagship()
    full = sum(p.numel() for p in port.parameters())
    sharded = tp.shard_params_tp(port, _meta_mesh())
    local = sum(p.numel() for p in sharded.parameters())
    assert full == 398_410_097
    # half of every split weight, but the odd-vocab logit's 15.36M stay whole
    logit = 512 * 30001
    assert local == 104_652_657 + logit + (241_459_712 - logit + 52_297_728) // 2
    assert 0.65 < local / full < 0.651
    assert type(sharded.text_decoder.logit) is tp.Dense
    dims = tp.split_dims(sharded)
    assert len(dims) == 121 - 1          # every split kernel but the logit
    assert dims["fusion.cross.fc_q.weight"] == 0 and dims["fusion.cross.fc_o.weight"] == 1
    assert not any(k.endswith(".bias") for k in dims)      # biases stay whole, as in JAX
    assert sharded.fusion.cross.num_heads == 4             # K3 on 4 of 8 heads a rank
    assert sharded.text_decoder.dec_0.self_attn.num_heads == 4
    assert tuple(sharded.fusion.cross.fc_q.weight.shape) == (8192, 2048)


def test_jax_spec_cases_and_the_divisibility_fallback():
    w = torch.empty(16, 8)           # a kernel [8, 16] in torch's layout

    def spec(*names, tensor=w, mp=0):
        return tp.tp_spec_for_name(".".join(names), tensor, mp)

    assert spec("dec_0", "self_attn", "wq", "weight") == tp.COLUMN
    assert spec("dec_0", "self_attn", "wo", "weight") == tp.ROW
    assert spec("layer_0", "attention", "out", "Dense_0", "weight") == tp.ROW
    assert spec("logit", "weight") == tp.COLUMN
    assert spec("bn1", "weight", tensor=torch.empty(8)) == tp.REPLICATED
    assert spec("dec_0", "ff", "Dense_0", "weight") == tp.COLUMN
    assert spec("dec_0", "ff", "Dense_1", "weight") == tp.REPLICATED
    assert spec("cln1", "mlp_gamma_1", "weight") == tp.REPLICATED
    assert spec("logit", "bias", tensor=torch.empty(16)) == tp.REPLICATED
    odd = torch.empty(30001, 512)
    assert spec("text_decoder", "logit", "weight", tensor=odd) == tp.COLUMN
    assert spec("text_decoder", "logit", "weight", tensor=odd, mp=2) == tp.REPLICATED
    assert spec("wo", "weight", tensor=torch.empty(8, 15), mp=2) == tp.REPLICATED


def test_mesh_layout_is_jax_reshape(devices):
    jm = jmesh.create_mesh(jmesh.MeshSpec(dp=2, mp=2))
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(4):
        m = _meta_mesh(rank, dp=2, mp=2)
        assert ids[m.dp_rank, m.mp_rank] == rank
        assert m.rows(8) == slice(4 * m.dp_rank, 4 * m.dp_rank + 4)
        assert m.shape == dict(jm.shape)
    assert tmesh.MeshSpec(dp=2, mp=2).n_devices == 4
    with pytest.raises(ValueError, match="mp must be >= 1"):
        tmesh.MeshSpec(mp=0)
    with pytest.raises(ValueError, match=r"one process per rank \(4\)"):
        tmesh.create_mesh(tmesh.MeshSpec(dp=2, mp=2), device="cpu")


def test_kernel_policies_decline_mp_and_k3_has_no_gate():
    mesh = _meta_mesh(dp=2, mp=2)
    assert not mesh_allows_kernels(mesh)
    auto = SimpleNamespace(beam_kv="auto", kv_cache_dtype="")
    assert resolve_beam_kv(auto, serving=True, mesh=mesh) == "reorder"
    assert not use_fused_logit_topk(SimpleNamespace(decoder_kind="r2gen"), True, mesh=mesh)
    import evoke_tpu_torch.ops.fusion_attention as fa

    assert "mesh" not in fa.masked_cross_view_attention.__code__.co_varnames


def test_an_mp_mesh_refuses_an_unsharded_model_and_captured_decoding():
    mesh = _meta_mesh(dp=1, mp=2)
    model = FinetuneModel(vocab_size=50, **TINY)
    opt = build_optimizer("RAdam", "finetune", model, pt_lr=1e-3, ft_lr=1e-3,
                          weight_decay=0.0)
    with pytest.raises(ValueError, match="shard_params_tp"):
        make_train_step(model, opt, 0, mesh=mesh)
    with pytest.raises(ValueError, match="shard_params_tp"):
        make_generate_step(model, Tok(50), DecodeConfig(beam_size=3), 16, device="cpu",
                           mesh=mesh)
    tp.shard_params_tp(model, mesh)
    with pytest.raises(ValueError, match="graphs=True with mp=2"):
        make_generate_step(model, Tok(50), DecodeConfig(beam_size=3), 16, device="cpu",
                           graphs=True, mesh=mesh)
    gen = make_generate_step(model, Tok(50), DecodeConfig(beam_size=3), 16, device="cpu",
                             mesh=mesh)
    assert gen.captured is False and not gen.ancestor_kv and not gen.fused_topk
    with pytest.raises(ValueError, match="already sharded"):
        tp.shard_params_tp(model, mesh)


def test_dryrun_at_4_ranks_prints_five_stages_at_dp2_mp2():
    out = subprocess.run([sys.executable, "-m", "evoke_tpu_torch.dryrun", "4", "--device",
                          "cpu"], capture_output=True, text=True, timeout=240, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("dryrun(4): ")]
    assert [line.split()[1] for line in lines] == ["train", "decode", "ckpt", "wide-fusion",
                                                   "engine"], out.stdout
    assert all("(dp=2, mp=2" in line for line in lines[:4]), out.stdout
    assert "captured=False" in lines[1]
    assert "pure-dp=4" in lines[4] and "16 reports" in lines[4]
