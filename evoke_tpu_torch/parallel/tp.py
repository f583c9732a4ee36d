"""Tensor parallelism over the mesh's ``mp`` axis (port of
evoke_tpu/parallel/tp.py).

The placement is JAX's rule, over the port's state-dict names (which keep
flax's module names, ``params.py``), stated in torch's layout (a ``Dense``
weight is ``[out, in]``):

- q / k / v (``wq``, ``wk``, ``wv``, ``fc_q/k/v``), the CLN's
  ``mlp_gamma_0`` / ``mlp_beta_0``, a ``Dense_0`` under a path holding ``ffn``
  or ``ff`` and ``logit`` split their OUTPUT dim (weight dim 0): column
  parallelism;
- ``wo``, ``fc_o`` and ``.../out/Dense_0`` split their INPUT dim (weight
  dim 1): row parallelism;
- everything else is replicated: every bias and 1-D leaf, and a weight whose
  split dim ``mp`` does not divide (JAX's ``tp.py:50-54``).

GSPMD inserts the collectives in JAX; here ``shard_params_tp`` replaces each
split ``Dense`` by a ``ColumnParallelDense`` / ``RowParallelDense`` holding
the rank's slice under the same parameter names, and the collectives are
written out (``parallel/collectives.py``). On its own a column-split
``Dense`` gathers its output along the last dim and a row-split one slices
its (replicated) input, so every split leaf computes exactly where it
stands; the attention blocks whose heads ``mp`` divides then keep q / k / v
at the rank's heads and feed them straight into the row-split output
projection, which sums over ``mp`` and adds its bias once, after the sum
(Megatron's pairing). Each output column of a column-split ``Dense`` is
computed whole by one rank; a row-split sum reorders additions, as GSPMD's
does.

Converters (``params.load_flax_variables``, ``models/torch_import``) run
on the full model, before ``shard_params_tp``, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from evoke_tpu_torch.models.layers import Dense
from evoke_tpu_torch.parallel.collectives import (all_gather_mp, copy_to_mp, gather_from_mp,
                                                  reduce_from_mp, scatter_to_mp)

# column-parallel: the weight's output dim (torch dim 0)
_COL_NAMES = ("wq", "wk", "wv", "fc_q", "fc_k", "fc_v", "mlp_gamma_0", "mlp_beta_0")
# row-parallel: the weight's input dim (torch dim 1)
_ROW_NAMES = ("wo", "fc_o", "out")

COLUMN = ("mp", None)
ROW = (None, "mp")
REPLICATED = ()


def tp_spec_for_name(name: str, tensor, mp: int = 0) -> Tuple:
    """JAX's ``tp_spec_for_path`` for the state-dict entry ``name`` holding
    ``tensor`` (anything with ``.shape``), in torch's layout: ``COLUMN``
    (weight dim 0 over ``mp``), ``ROW`` (dim 1) or ``REPLICATED``. With
    ``mp`` > 0 a split dim that ``mp`` does not divide falls back to
    ``REPLICATED``, as JAX's ``shard_params_tp`` does."""
    names = name.split(".")
    if names[-1] != "weight" or len(tensor.shape) != 2:
        return REPLICATED
    parent = names[-2] if len(names) >= 2 else ""
    grandparent = names[-3] if len(names) >= 3 else ""
    spec = REPLICATED
    if parent in _COL_NAMES:
        spec = COLUMN
    elif parent in _ROW_NAMES or grandparent in _ROW_NAMES:
        spec = ROW
    elif parent == "Dense_0" and ("ffn" in names or "ff" in names):
        spec = COLUMN
    elif parent == "logit":
        spec = COLUMN
    if spec and mp > 0 and tensor.shape[spec.index("mp")] % mp:
        return REPLICATED
    return spec


class ColumnParallelDense(Dense):
    """A ``Dense`` holding rows ``[r * out / mp, (r + 1) * out / mp)`` of its
    weight (``r`` the mp rank) and, as JAX places it, the whole bias.
    ``gather``: the product is gathered over ``mp`` along the last dim and
    the bias added (the full width, each column computed by one rank); off,
    the output is the rank's slice (an attention block's heads) and takes
    its slice of the bias (whose gradient is gathered back, so the bias
    stays replicated)."""

    split_dim = 0

    def __init__(self, dense: Dense, mesh):
        nn.Module.__init__(self)
        self.dtype = dense.dtype
        self.mesh = mesh
        self.gather = True
        self.out_features = dense.weight.shape[0]
        k = self.out_features // mesh.mp
        rows = slice(mesh.mp_rank * k, (mesh.mp_rank + 1) * k)
        self.weight = nn.Parameter(dense.weight.detach()[rows].clone(),
                                   requires_grad=dense.weight.requires_grad)
        self.bias = nn.Parameter(dense.bias.detach().clone(),
                                 requires_grad=dense.bias.requires_grad)

    @property
    def out_width(self) -> int:
        return self.out_features if self.gather else self.weight.shape[0]

    def forward(self, x):
        x = copy_to_mp(x, self.mesh)
        dt = self.dtype if self.dtype is not None else torch.promote_types(
            x.dtype, self.weight.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        if self.gather:
            return gather_from_mp(y, self.mesh) + self.bias.to(dt)
        return y + scatter_to_mp(self.bias, self.mesh).to(dt)


class RowParallelDense(Dense):
    """A ``Dense`` holding columns ``[r * in / mp, (r + 1) * in / mp)`` of its
    weight and the whole bias. Its partial product (float32) is summed over
    ``mp``, rounded to the compute dtype, and the bias added once after the
    sum. ``scatter``: the input is replicated and the rank takes its slice;
    off, the input already is the rank's slice (an attention block's heads)."""

    split_dim = 1

    def __init__(self, dense: Dense, mesh):
        nn.Module.__init__(self)
        self.dtype = dense.dtype
        self.mesh = mesh
        self.scatter = True
        k = dense.weight.shape[1] // mesh.mp
        cols = slice(mesh.mp_rank * k, (mesh.mp_rank + 1) * k)
        self.weight = nn.Parameter(dense.weight.detach()[:, cols].clone(),
                                   requires_grad=dense.weight.requires_grad)
        self.bias = nn.Parameter(dense.bias.detach().clone(),
                                 requires_grad=dense.bias.requires_grad)

    def forward(self, x):
        if self.scatter:
            x = scatter_to_mp(x, self.mesh)
        dt = self.dtype if self.dtype is not None else torch.promote_types(
            x.dtype, self.weight.dtype)
        part = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return reduce_from_mp(part.float(), self.mesh).to(dt) + self.bias.to(dt)


PARALLEL = (ColumnParallelDense, RowParallelDense)


def _set_child(model: nn.Module, name: str, child: nn.Module) -> None:
    parent, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, leaf, child)


@torch.no_grad()
def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model`` (holding its full weights) over ``mesh``'s mp axis, in
    place: every ``Dense`` that the rule splits, and whose split dim ``mp``
    divides, becomes a ``ColumnParallelDense`` / ``RowParallelDense`` with
    this rank's slice, under the same parameter names; then every module
    with a ``split_heads_tp`` method (the attention blocks) takes the rank's
    heads where it can. Raises if a split leaf is not a ``Dense``'s weight.
    Build the optimizer after this call (its masters take the local
    shapes). A mesh with mp == 1 (or None) leaves the model as it is."""
    if mesh is None or mesh.mp == 1:
        return model
    if getattr(model, "decoder_kind", None) == "mla_moe":
        raise NotImplementedError(f"mp={mesh.mp} with decoder_kind='mla_moe': the MLA + MoE "
                                  "decoder has no tensor-parallel split; serve it on one "
                                  "device per replica (dp) instead")
    if getattr(model, "tp_mesh", None) is not None:
        raise ValueError("shard_params_tp: the model is already sharded")
    modules = dict(model.named_modules())
    for name, p in list(model.named_parameters()):
        if not tp_spec_for_name(name, p, mesh.mp):
            continue
        owner = modules.get(name.rpartition(".")[0])
        if type(owner) is not Dense:
            raise TypeError(f"shard_params_tp: {name} is split by the rule but its module is "
                            f"{type(owner).__name__}, not a Dense")
        cls = ColumnParallelDense if tp_spec_for_name(name, p) == COLUMN else RowParallelDense
        _set_child(model, name.rpartition(".")[0], cls(owner, mesh))
    for m in model.modules():
        if hasattr(m, "split_heads_tp"):
            m.split_heads_tp(mesh)
    model.tp_mesh = mesh
    model.tp_dims = _split_dims(model)
    return model


def split_dims(model: nn.Module) -> Dict[str, int]:
    """State-dict name -> the dim split over mp, for every split weight of a
    ``shard_params_tp`` model; empty for a model that is not sharded."""
    if getattr(model, "tp_mesh", None) is None:
        return {}
    return model.tp_dims


def _split_dims(model: nn.Module) -> Dict[str, int]:
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, PARALLEL):
            out[f"{name}.weight" if name else "weight"] = m.split_dim
    return out


def full_shape(model: nn.Module, name: str, local_shape) -> Tuple[int, ...]:
    """The shape one device holds for entry ``name`` of this rank's shape
    ``local_shape``."""
    shape = list(local_shape)
    dim = split_dims(model).get(name)
    if dim is not None:
        shape[dim] *= model.tp_mesh.mp
    return tuple(shape)


def local_slice(model: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the full tensor ``full`` of entry ``name``
    (``full`` itself where ``name`` is replicated)."""
    dim = split_dims(model).get(name)
    if dim is None:
        return full
    mesh = model.tp_mesh
    k = full.shape[dim] // mesh.mp
    return full.narrow(dim, mesh.mp_rank * k, k)


@torch.no_grad()
def gather_full(tensors: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, torch.Tensor]:
    """``tensors`` (name -> this rank's tensor, keyed like the model's state
    dict: parameters, their masters or moments) with every split entry
    gathered over mp into its full tensor. Every mp rank must call it with
    the same names, in the same order."""
    dims = split_dims(model)
    return {k: all_gather_mp(v, model.tp_mesh, dims[k]) if k in dims else v
            for k, v in tensors.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every split tensor gathered (what one
    device holds)."""
    return gather_full(model.state_dict(), model)


@torch.no_grad()
def replicate_params(model: nn.Module) -> nn.Module:
    """Undo ``shard_params_tp`` in place: every parallel ``Dense`` becomes a
    plain ``Dense`` holding the gathered full weights, every attention block
    takes all its heads again. Every mp rank must call it."""
    mesh = getattr(model, "tp_mesh", None)
    if mesh is None:
        return model
    for name, m in list(model.named_modules()):
        if isinstance(m, PARALLEL):
            w = all_gather_mp(m.weight, mesh, m.split_dim)
            dense = Dense(w.shape[1], w.shape[0], m.dtype).to(w.device)
            dense.weight.data.copy_(w)
            dense.bias.data.copy_(m.bias)
            _set_child(model, name, dense)
    for m in model.modules():
        if hasattr(m, "split_heads_tp"):
            m.split_heads_tp(None)
    model.tp_mesh = model.tp_dims = None
    return model
