"""The collectives a dp mesh needs, written out (port of
evoke_tpu/parallel/collectives.py).

JAX's GSPMD inserts them; here each is a ``torch.distributed`` call over the
mesh's group, differentiable where the train step needs a gradient through
it. Only collectives that gloo also carries on CUDA tensors are used: list
``all_gather``, ``all_reduce`` and ``broadcast`` (two ranks sharing one card
must run on gloo: NCCL refuses them). A one-rank mesh without a process
group makes every one of them the identity.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def _collective(mesh) -> bool:
    return mesh is not None and mesh.group is not None


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """[n, ...] per rank -> [dp * n, ...] in rank order."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.dp)]
    dist.all_gather(parts, wire, group=mesh.group)
    out = torch.cat(parts, 0)
    return out.bool() if x.dtype == torch.bool else out


def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=mesh.group)
    return out


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
def all_reduce_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Sum each tensor over ranks in place, one flat buffer per dtype."""
    if not _collective(mesh):
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=mesh.group)
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh, src: int = 0) -> None:
    """Copy rank ``src``'s values of each tensor into every rank's, in place."""
    if not _collective(mesh):
        return
    for t in tensors:
        buf = t if t.is_contiguous() else t.contiguous()
        dist.broadcast(buf, src, group=mesh.group)
        if buf is not t:
            t.copy_(buf)


def gather_objects(obj: Any, mesh) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if not _collective(mesh):
        return [obj]
    out: List[Any] = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh) -> None:
    if _collective(mesh):
        dist.barrier(group=mesh.group)
