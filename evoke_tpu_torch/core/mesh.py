"""The dp x mp mesh over ``torch.distributed`` (port of
evoke_tpu/core/mesh.py).

The reference's only multi-device strategy is single-process
``torch.nn.DataParallel`` (EVOKE modules/trainer_v0401.py:28-29); the JAX
package runs a GSPMD mesh whose ``dp`` axis shards every batch leaf's leading
dim, XLA inserting the all-gathers and sums. The port runs one process per
rank instead: a rank holds its contiguous block of each leaf's rows
(``shard_batch``), and the collectives XLA would insert are written out
(``parallel/collectives.py``): the visual features are gathered at the
fusion boundary, BatchNorm's sums and the loss denominators are summed, and
the gradients are summed before the optimizer, so a dp run computes what the
one-device run computes on the global batch.

``use_mesh(mesh)`` makes a mesh active for the model code that needs it
(BatchNorm statistics, dropout masks, the fusion gather, the losses); the
steps and servers built with ``mesh=`` enter it around their model calls.
The decode loops of a pure-dp mesh need no collective, so none runs inside
a CUDA graph.

``MeshSpec(dp, mp)`` lays global rank ``r`` at ``(dp_idx, mp_idx) = (r // mp,
r % mp)``, JAX's ``devices.reshape(dp, mp)``: the ``mp`` ranks of one dp
group hold the same rows, and each holds its slice of the tensor-parallel
parameters (``parallel/tp.py``). The batch collectives run over the rank's
``dp_group``, the tensor-parallel ones over its ``mp_group``; ``group`` is
the world (checkpoints, barriers). NCCL carries CUDA tensors, gloo the
CPU's; ranks share a card only when the caller lists the devices explicitly.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh: dp = data parallel, mp = model (tensor) parallel."""

    dp: int = 1
    mp: int = 1

    def __post_init__(self):
        if self.dp < 1:
            raise ValueError(f"MeshSpec(dp={self.dp}): dp must be >= 1")
        if self.mp < 1:
            raise ValueError(f"MeshSpec(mp={self.mp}): mp must be >= 1")

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a dp x mp mesh: global ``rank`` sits at
    ``(dp_rank, mp_rank) = (rank // mp, rank % mp)`` and owns rows
    ``[dp_rank * n / dp, (dp_rank + 1) * n / dp)`` of every sharded leading
    dim. ``group`` is the world's process group, ``dp_group`` the ranks of
    this rank's mp index (the batch collectives), ``mp_group`` the ranks of
    its dp index (the tensor-parallel collectives). Without
    ``torch.distributed`` all are None; with it, ``mp_group`` is None at
    mp == 1 and ``dp_group`` at dp == 1 < mp. Every collective over a
    missing group is the identity."""

    dp: int
    mp: int
    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    dp_group: Any = None
    mp_group: Any = None

    @property
    def shape(self):
        """The JAX mesh's axis sizes, for the policies that read them."""
        return {"dp": self.dp, "mp": self.mp}

    @property
    def dp_rank(self) -> int:
        return self.rank // self.mp

    @property
    def mp_rank(self) -> int:
        return self.rank % self.mp

    def rows(self, n: int) -> slice:
        """This rank's block of a leading dim of ``n`` (``n % dp == 0``)."""
        if n % self.dp:
            raise ValueError(f"leading dim {n} is not divisible by dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)


_ACTIVE: ContextVar = ContextVar("evoke_torch_mesh", default=None)


def active_mesh() -> Optional[Mesh]:
    """The mesh the running model call is sharded over, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the enclosed model calls over ``mesh`` (None: one device)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def visible_devices(device="cuda") -> int:
    """Devices a mesh may take: the visible cards, or 1 on the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def check_devices(spec: MeshSpec, device="cuda", devices: Optional[Sequence] = None) -> None:
    """JAX's ``create_mesh`` check: a spec never takes more cards than are
    visible, unless the caller lists the devices (ranks sharing a card)."""
    if devices is not None:
        if len(devices) < spec.n_devices:
            raise ValueError(f"mesh {spec} needs {spec.n_devices} devices, got "
                             f"{len(devices)} listed")
        return
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if spec.n_devices > have:
            raise ValueError(f"mesh {spec} needs {spec.n_devices} devices, have {have}")


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     device="cuda", timeout_s: Optional[float] = None) -> int:
    """Join (or create) the default process group; returns the world size.

    With no arguments it reads torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); a single process with none
    of them gets a no-op (world size 1, no group). ``backend`` defaults to
    NCCL for CUDA and gloo for the CPU; NCCL failing is never retried on
    gloo."""
    if dist.is_initialized():
        return dist.get_world_size()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if world_size > 1:
            raise ValueError(f"world size {world_size} needs an init_method or torchrun's "
                             "MASTER_ADDR / MASTER_PORT")
        return 1
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout_s is None else {"timeout": _timedelta(timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    return world_size


def _timedelta(seconds: float):
    import datetime

    return datetime.timedelta(seconds=seconds)


def create_mesh(spec: Optional[MeshSpec] = None, device="cuda",
                devices: Optional[Sequence] = None) -> Mesh:
    """This rank's ``Mesh`` over the default process group.

    ``spec=None`` takes every rank of the group on the dp axis; ``dp * mp``
    must equal the group's size. ``device``: ``cuda`` gives rank r ``cuda:r`` (a spec larger than the visible cards
    raises ``ValueError``, as JAX's does); ``cpu`` gives every rank the CPU.
    ``devices`` lists each rank's device explicitly (ranks may then share a
    card). Without ``torch.distributed`` initialised only a one-rank mesh
    exists."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if spec is None:
        spec = MeshSpec(dp=world)
    check_devices(spec, device, devices)
    if spec.n_devices != world:
        raise ValueError(f"mesh {spec} needs one process per rank ({spec.n_devices}): the "
                         f"process group has {world}")
    if devices is not None:
        dev = torch.device(devices[rank])
    elif torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    if dev.type == "cuda":
        from evoke_tpu_torch.core.device import resolve_device

        resolve_device(dev)
        torch.cuda.set_device(dev)
    group = dist.group.WORLD if dist.is_initialized() else None
    dp_group, mp_group = _axis_groups(spec, rank) if group is not None else (None, None)
    return Mesh(dp=spec.dp, mp=spec.mp, rank=rank, world_size=world, device=dev, group=group,
                dp_group=dp_group, mp_group=mp_group)


def _axis_groups(spec: MeshSpec, rank: int):
    """(dp_group, mp_group) of ``rank``: the world where an axis spans it (a
    pure-dp mesh's dp axis, at any size, as before tensor parallelism), None
    for an axis of one rank beside the other, else a new group. Every rank
    creates every group, in one order, as ``dist.new_group`` requires."""
    dp, mp = spec.dp, spec.mp
    world = dist.group.WORLD

    def groups(members):
        mine = None
        for ranks in members:
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        return mine

    if mp == 1:
        return world, None
    if dp == 1:
        return None, world
    dp_group = groups([[d * mp + m for d in range(dp)] for m in range(mp)])
    mp_group = groups([[d * mp + m for m in range(mp)] for d in range(dp)])
    return dp_group, mp_group


def _leaf_rows(x, mesh: Mesh, allow_replicate: bool):
    """One leaf -> this rank's rows on ``mesh.device`` (see shard_batch)."""
    on_device = torch.is_tensor(x) and x.device == mesh.device
    if not on_device:
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if x.ndim == 0 or (x.shape[0] % mesh.dp and allow_replicate):
        return x if on_device else _to(x, mesh.device)
    if x.shape[0] % mesh.dp:
        raise ValueError(
            f"shard_batch: leading dim {x.shape[0]} of a leaf with shape {tuple(x.shape)} "
            f"is not divisible by dp={mesh.dp}; pad the batch to a multiple of dp, or pass "
            "allow_replicate=True to replicate such leaves explicitly")
    if mesh.dp == 1 and on_device:
        return x
    local = x[mesh.rows(x.shape[0])]
    return local if on_device else _to(local.contiguous(), mesh.device)


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def shard_batch(batch: Any, mesh: Mesh, allow_replicate: bool = False) -> Any:
    """This rank's rows of every leaf of a (nested dict / list / tuple) batch
    of host arrays or tensors, on the rank's device.

    0-d leaves are replicated. A leading dim that does not divide dp raises:
    replicating it silently would drop data parallelism and change the
    global-batch semantics the losses assume; ``allow_replicate=True``
    replicates such leaves explicitly. A tensor already on the rank's device
    is sliced there (a view; at dp=1 the same tensor), never copied through
    the host."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, allow_replicate) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, allow_replicate) for v in batch)
    return _leaf_rows(batch, mesh, allow_replicate)


def local_slice(total: int, mesh: Mesh) -> int:
    """Per-rank size of a dp-sharded leading dim."""
    return total // mesh.dp


def rendezvous_file() -> str:
    """A ``file://`` init method in a new directory under the temp dir: no
    other group can share it, as a TCP port picked free may be taken before
    rank 0 binds it."""
    return "file://" + os.path.join(tempfile.mkdtemp(prefix="evoke_rdzv_"), "rendezvous")


def _rank_main(rank, fn, spec, backend, init_method, device, devices, args, timeout_s):
    world_size = spec.n_devices
    init_distributed(backend, init_method, world_size, rank, device=device,
                     timeout_s=timeout_s)
    try:
        fn(create_mesh(spec, device=device, devices=devices), *args)
        dist.barrier()
    except BaseException:
        # the caller's exception names one failed rank: print each rank's own
        # cause, since a rank's failure makes the others' collectives fail too
        import sys
        import traceback

        print(f"rank {rank} of {world_size}:", file=sys.stderr)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: Optional[int] = None, args: tuple = (), *, spec=None,
          device="cuda", devices=None, backend: Optional[str] = None,
          init_method: Optional[str] = None, timeout_s: Optional[float] = None) -> None:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes, one per rank
    (``fn`` must be importable by name: the processes are spawned), over
    ``spec`` (a ``MeshSpec``; None: ``MeshSpec(dp=world_size)``; given, its
    ``dp * mp`` ranks are spawned and ``world_size`` may be left out). The group
    is NCCL on CUDA (rank r on ``cuda:r``; more ranks than visible cards
    raise ``ValueError``), gloo with ``device="cpu"``, unless ``backend``
    says otherwise; ``devices`` lists each rank's device (two ranks on one
    card need it, and then gloo, which NCCL refuses). ``init_method``
    defaults to a ``rendezvous_file()`` of this call's own.
    ``timeout_s``: the ranks are killed and ``TimeoutError`` raised when they
    outlast it (also the group's collective timeout). Raises when a rank
    fails; returns when every rank is done."""
    import torch.multiprocessing as mp

    if spec is None:
        spec = MeshSpec(dp=world_size)
    elif world_size is not None and world_size != spec.n_devices:
        raise ValueError(f"spawn: world_size {world_size} != {spec}'s {spec.n_devices} ranks")
    world_size = spec.n_devices
    if devices is None:
        check_devices(spec, device)
    if backend is None:
        kind = torch.device(devices[0] if devices else device).type
        backend = "nccl" if kind == "cuda" else "gloo"
    own = init_method is None
    init_method = rendezvous_file() if own else init_method
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, spec, backend, init_method,
                                                   device, devices, tuple(args), timeout_s),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"spawn: {world_size} ranks of "
                                   f"{getattr(fn, '__name__', fn)} outlasted {timeout_s} s")
    finally:
        if own:
            shutil.rmtree(os.path.dirname(init_method[len("file://"):]), ignore_errors=True)
