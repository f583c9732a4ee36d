"""The mesh gates of the serving kernels (port of evoke_tpu/ops/sharding.py).

JAX wraps each Pallas call in ``shard_map`` over 'dp', carrying the mesh to
the kernel dispatchers through a trace-time context. The port needs no such
context: every rank calls its kernels (K1, the lineage attention, and K2,
the fused logit + top-k) on the rows it holds. What stays is JAX's policy:
K1 and K2 ride a pure-dp mesh and are declined on one with mp > 1, where the
serving path takes reorder caches and the unfused vocab tail:
``train/steps.resolve_beam_kv(mesh=)`` (ancestor caches, read by K1) and
``ops/fused_logit_topk.use_fused_logit_topk(mesh=)`` (K2) read
``mesh_allows_kernels``. K3, the fusion attention, has no mesh gate (nor
has JAX's): under tensor parallelism each rank calls it on its own heads
(``models/fusion.py``). The sample batch must divide dp, which
``core/mesh.shard_batch`` enforces by raising: nothing falls back.
"""

from __future__ import annotations


def mesh_allows_kernels(mesh) -> bool:
    """The serving kernels ride the mesh only when it is pure dp (mp == 1)."""
    return mesh is None or int(mesh.shape.get("mp", 1)) == 1


def dp_size(mesh) -> int:
    return int(mesh.shape.get("dp", 1)) if mesh is not None else 1


def check_divisible(n: int, mesh, what: str = "sample batch") -> None:
    """Raise unless ``n`` rows split evenly over the mesh's dp ranks."""
    dp = dp_size(mesh)
    if n % dp:
        raise ValueError(f"{what} of {n} rows does not divide dp={dp}: pad it to a "
                         "multiple of dp")
