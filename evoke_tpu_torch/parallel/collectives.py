"""The collectives a dp x mp mesh needs, written out (port of
evoke_tpu/parallel/collectives.py).

JAX's GSPMD inserts them; here each is a ``torch.distributed`` call,
differentiable where the train step needs a gradient through it:

- the batch collectives (``all_gather_batch``, ``all_reduce_sum``,
  ``psum_mean``, ``make_shardmap_loss``) run over the rank's ``dp_group``:
  the ``mp`` ranks of a dp group hold the same rows, so a gather over the
  world would return each row ``mp`` times;
- the tensor-parallel operators (``copy_to_mp``, ``reduce_from_mp``,
  ``gather_from_mp``, ``scatter_to_mp``) run over its ``mp_group``, each an
  ``autograd.Function`` with the standard rule: the input of a
  column-split ``Dense`` is the identity forward and an all-reduce backward;
  a row-split output an all-reduce forward and the identity backward; a
  gather along the last dim takes the rank's slice backward; a slice of a
  replicated input all-gathers backward;
- ``all_reduce_`` (gradients) takes the axis; ``broadcast_``,
  ``gather_objects`` and ``barrier`` run over the world.

Only collectives that gloo also carries on CUDA tensors are used: list
``all_gather``, ``all_reduce`` and ``broadcast`` (two ranks sharing one card
must run on gloo: NCCL refuses them). An axis of one rank has no group, and
every collective over it is the identity.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def _axis(mesh, axis: Optional[str]):
    """(group, size) of ``mesh``'s axis ``"dp"`` or ``"mp"``, or of the
    world (None); the group is None where the collective is the identity."""
    if mesh is None:
        return None, 1
    if axis == "dp":
        return mesh.dp_group, mesh.dp
    if axis == "mp":
        return mesh.mp_group, mesh.mp
    return mesh.group, mesh.world_size


def _collective(mesh, axis: Optional[str] = "dp") -> bool:
    return _axis(mesh, axis)[0] is not None


def _gather(x: torch.Tensor, mesh, axis: str = "dp", dim: int = 0) -> torch.Tensor:
    """[.., n, ..] per rank -> [.., size * n, ..] along ``dim``, in rank order."""
    group, size = _axis(mesh, axis)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def _sum(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_axis(mesh, axis)[0])
    return out


def _own(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's mp slice of ``x`` along ``dim``."""
    k = x.shape[dim] // mesh.mp
    return x.narrow(dim, mesh.mp_rank * k, k)


class _AllGatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        # every rank's loss share reaches the gathered rows: the sum over
        # ranks is the global batch's gradient, of which a rank keeps its rows
        mesh = ctx.mesh
        return _sum(grad, mesh)[mesh.rows(grad.shape[0])], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh), None


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh, "mp"), None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh, "mp")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh, "mp", dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return _own(grad, ctx.mesh).contiguous(), None


class _ScatterToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _own(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.mesh, "mp", dim=-1), None


def _tp(fn, x, mesh, plain):
    if not _collective(mesh, "mp"):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return fn.apply(x, mesh)
    return plain(x)


def copy_to_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-split ``Dense``: the identity; its backward sums
    the ranks' partial input gradients over ``mp``."""
    return _tp(_CopyToMp, x, mesh, lambda t: t)


def reduce_from_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-split ``Dense``'s partial product summed over ``mp``; the
    backward passes the (replicated) gradient through."""
    return _tp(_ReduceFromMp, x, mesh, lambda t: _sum(t, mesh, "mp"))


def gather_from_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's last-dim slice, concatenated in mp order; the backward
    keeps this rank's slice."""
    return _tp(_GatherFromMp, x, mesh, lambda t: _gather(t, mesh, "mp", dim=-1))


def scatter_to_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's last-dim slice of a replicated ``x``; the backward
    gathers the slices' gradients."""
    return _tp(_ScatterToMp, x, mesh, lambda t: _own(t, mesh).contiguous())


@torch.no_grad()
def all_gather_mp(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every mp rank's slice of ``x`` concatenated along ``dim`` (no
    gradient): a split tensor's full value."""
    if not _collective(mesh, "mp"):
        return x
    return _gather(x.detach(), mesh, "mp", dim=dim)


@torch.no_grad()
def max_over_mp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max over the mp ranks (a new tensor; no gradient)."""
    if not _collective(mesh, "mp"):
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.mp_group)
    return out


def all_gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows [b_local, ...] -> the global batch [dp * b_local, ...].

    Differentiable: the backward sums the gathered rows' gradients over the
    ranks and keeps this rank's rows, so the gradients are those of the
    global batch (each rank's loss being its share of the global loss)."""
    if not _collective(mesh):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGatherBatch.apply(x, mesh)
    return _gather(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks (a new tensor); differentiable (its backward sums
    the gradient over ranks)."""
    if not _collective(mesh):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllReduceSum.apply(x, mesh)
    return _sum(x, mesh)


def psum_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mean over the data-parallel axis (metric reduction)."""
    if not _collective(mesh):
        return x
    return all_reduce_sum(x, mesh) / mesh.dp


def make_shardmap_loss(mesh, loss_fn: Callable[..., torch.Tensor]):
    """Wrap a global-batch loss: ``run(*shards)`` gathers every rank's rows
    and returns ``loss_fn`` of the global arrays on every rank.

    ``loss_fn`` must not depend on which rank computes it (the contrastive
    losses do not). A rank that backpropagates the result gives the global
    gradient times dp; a train step backpropagates ``run(...) / dp``."""

    def run(*shards):
        return loss_fn(*[all_gather_batch(s, mesh) for s in shards])

    return run


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor], mesh, axis: Optional[str] = "dp") -> None:
    """Sum each tensor over the ranks of ``axis`` ("dp", "mp", or None: the
    world) in place, one flat buffer per dtype."""
    group, _ = _axis(mesh, axis)
    if group is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Copy global rank ``src``'s values of each tensor into every rank's, in
    place."""
    if not _collective(mesh, None):
        return
    for t in tensors:
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src, group=mesh.group)
        if buf is not t:
            t.copy_(buf)


def gather_objects(obj: Any, mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in global rank order, on every rank."""
    if not _collective(mesh, None):
        return [obj]
    out: List[Any] = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh) -> None:
    if _collective(mesh, None):
        dist.barrier(group=mesh.group)
