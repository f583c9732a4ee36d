"""Fused logit projection + stage-1 top-k + logsumexp (kernel K2).

Port of ``evoke_tpu/ops/fused_logit_topk.py`` (``_pallas_topk`` / ``_kernel``),
the serving beam step's vocab tail. For h [N, D], the logit head's weight
W [V, D] (the port's Linear layout) and bias b [V], all in one dtype:

    logits = dtype(h @ W.T) + b          # two roundings, as nn.Dense(dtype)
    lse    = logsumexp(float32(logits))  # PRE-suppression
    logits[:, sid] += dtype(-1000)       # for sid in suppress_ids
    vals, idx = top-k(logits), ties to the lowest index; vals float32

``fused_logit_topk`` is the wrapper: a CPU tensor takes
``fused_logit_topk_plain``; a CUDA tensor launches
``csrc/fused_logit_topk.cu`` (built at first use) or raises. bfloat16 runs the
TMA + wgmma route, sized by ``launch_plan``; float32 the 32-column FMA route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 8
MAX_SUPPRESS = 4
F32_TILE = 32          # vocab columns per block, float32 route
BF16_TILE = 232        # vocab columns per block, bfloat16 route (the wgmma N)
ROW_PASS_MAX = 192     # rows per pass: three consumer warpgroups of 64
DEPTH_STAGE = 64       # h / W depth per ring stage (one 128-byte swizzled row)
MAX_STAGES = 4
SMEM_LIMIT = 232448    # bytes of shared memory a block may use on Hopper (227 KB)
H100_SMS = 132


def launch_plan(n: int, d: int, v: int, k: int, tv: int = BF16_TILE,
                sms: int = H100_SMS) -> dict:
    """The bfloat16 route's launch for h [n, d], W [v, d] and top-k: tiles of
    ``tv`` vocab columns (one block each, ``grid`` blocks striding over them),
    row passes of up to 192 rows with one warpgroup per 64, a ring
    of up to 4 stages that fits the shared memory, and the partials' size.
    ``csrc/fused_logit_topk.cu`` takes rows per pass, stages, shared memory
    and grid from here and refuses a plan whose bytes disagree with its own."""
    if tv % 8 or not 8 <= tv <= 256:
        raise ValueError(f"tile {tv}: a wgmma N and a TMA box are multiples of 8 up to 256")
    tiles = -(-v // tv)
    row_pass = min(64 * -(-n // 64), ROW_PASS_MAX)
    stage_bytes = (row_pass + tv) * DEPTH_STAGE * 2
    fixed = 1024 + tv * 2 + tv               # alignment slack, bf16 bias, column flags
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (stage_bytes + 16))
    warpgroups = row_pass // 64
    return dict(tiles=tiles, grid=min(tiles, sms), row_pass=row_pass,
                passes=-(-n // row_pass), warpgroups=warpgroups,
                threads=warpgroups * 128, depth_steps=-(-d // DEPTH_STAGE),
                stages=stages, stage_bytes=stage_bytes,
                smem_bytes=fixed + stages * (stage_bytes + 16),
                partial_floats=tiles * n * (2 + 2 * k))


def topk_lowest_index(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, ties resolved to the lowest index (the order
    of ``lax.top_k``; ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def fused_logit_topk_plain(h, w, b, k: int, suppress_ids: Sequence[int] = ()):
    """The plain PyTorch version: matmul, rounded to the dtype, a separate bias
    add in the dtype (not ``F.linear``, whose fused epilogue adds the bias
    before rounding), the logsumexp, the suppression, the tie-ordered top-k."""
    logits = torch.matmul(h, w.t())
    logits = logits + b
    lse = torch.logsumexp(logits.float(), dim=-1)
    for sid in suppress_ids:
        logits[:, sid] += -1000.0
    vals, idx = topk_lowest_index(logits, k)
    return vals.float(), idx.to(torch.int32), lse


def _check(h, w, b, k, suppress_ids):
    if h.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"need h [N, D], w [V, D], b [V]; got {tuple(h.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    n, d = h.shape
    v, dd = w.shape
    if dd != d or b.shape[0] != v:
        raise ValueError(f"shape mismatch: h {tuple(h.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k={k} outside 1..{min(MAX_K, v)}")
    if len(suppress_ids) > MAX_SUPPRESS or any(not 0 <= s < v for s in suppress_ids):
        raise ValueError(f"suppress_ids {tuple(suppress_ids)}: at most {MAX_SUPPRESS} "
                         f"ids in [0, {v})")
    if h.dtype not in _DTYPES or w.dtype != h.dtype or b.dtype != h.dtype:
        raise TypeError(f"dtypes h {h.dtype}, w {w.dtype}, b {b.dtype}: need one of "
                        "float32 / bfloat16 for all three")
    for name, t in (("h", h), ("w", w), ("b", b)):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {h.device}")


@functools.cache
def _lib():
    """Build (first use), load and bind the kernel's C entry points."""
    from evoke_tpu_torch.ops import _build

    lib = _build.load("fused_logit_topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_logit_topk_launch.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.fused_logit_topk_bf16_launch.argtypes = [p] * 9 + [i] * 13 + [p]
    lib.fused_logit_topk_encode_w.argtypes = [p, p, i, i]
    lib.fused_logit_topk_tile.argtypes = [i]
    for fn in (lib.fused_logit_topk_launch, lib.fused_logit_topk_bf16_launch,
               lib.fused_logit_topk_encode_w, lib.fused_logit_topk_tile):
        fn.restype = i
    tiles = (lib.fused_logit_topk_tile(0), lib.fused_logit_topk_tile(1))
    if tiles != (F32_TILE, BF16_TILE):
        raise RuntimeError(f"fused_logit_topk.cu tiles {tiles}, wrapper expects "
                           f"{(F32_TILE, BF16_TILE)}")
    return lib


@functools.lru_cache(maxsize=8)
def _w_map(ptr: int, v: int, d: int):
    """W's TMA descriptor (128 bytes), encoded once per (pointer, shape)."""
    buf = ctypes.create_string_buffer(128)
    rc = _lib().fused_logit_topk_encode_w(buf, ptr, v, d)
    if rc != 0:
        raise RuntimeError(f"fused_logit_topk: W tensor map encoding failed ({rc})")
    return buf


@functools.lru_cache(maxsize=64)
def _bf16_plan(n: int, d: int, v: int, k: int, index: int) -> Tuple[int, ...]:
    """``launch_plan``'s launch arguments on device ``index``, once per shape:
    tiles, rows per pass, stages, shared-memory bytes, grid."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    p = launch_plan(n, d, v, k, sms=sms)
    return p["tiles"], p["row_pass"], p["stages"], p["smem_bytes"], p["grid"]


def fused_logit_topk(h, w, b, k: int, suppress_ids: Sequence[int] = ()):
    """h [N, D], w [V, D], b [V] (one dtype) -> (vals [N, k] f32, idx [N, k]
    i32, lse [N] f32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``fused_logit_topk.launches``) or raises.
    Under CUDA graph capture this call runs once, at capture: outputs and
    workspace come from the graph's memory pool, h's and W's tensor maps hold
    their addresses (W must not move afterwards), and whoever replays the
    graph counts its launches (``decode/beam.LaunchLedger``)."""
    suppress_ids = tuple(int(s) for s in suppress_ids)
    if h.device.type == "cpu":
        return fused_logit_topk_plain(h, w, b, k, suppress_ids)
    if h.device.type != "cuda":
        raise ValueError(f"fused_logit_topk: unsupported device {h.device}")
    _check(h, w, b, k, suppress_ids)
    n, d = h.shape
    v = w.shape[0]
    bf16 = h.dtype == torch.bfloat16
    if bf16 and (d % 8 or h.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("fused_logit_topk bfloat16: D must be a multiple of 8 and h, w "
                         "16-byte aligned (TMA rows)")
    lib = _lib()
    vals = torch.empty(n, k, dtype=torch.float32, device=h.device)
    idx = torch.empty(n, k, dtype=torch.int32, device=h.device)
    lse = torch.empty(n, dtype=torch.float32, device=h.device)
    sup = list(suppress_ids) + [-1] * (MAX_SUPPRESS - len(suppress_ids))
    args = (n, d, v, int(k), len(suppress_ids), *sup)
    outs = (vals.data_ptr(), idx.data_ptr(), lse.data_ptr())
    stream = torch.cuda.current_stream(h.device).cuda_stream
    if bf16:
        nt, *launch = _bf16_plan(n, d, v, int(k), h.device.index or 0)
        # one workspace: top-k keys [nt * n * k] int64 (value bits, ~index),
        # then the max and the sum of exp [nt * n] float32 each
        ws = torch.empty(nt * n * (k + 1), dtype=torch.int64, device=h.device)
        key = ws.data_ptr()
        part_m = key + nt * n * k * 8
        rc = lib.fused_logit_topk_bf16_launch(
            _w_map(w.data_ptr(), v, d), h.data_ptr(), b.data_ptr(), part_m, part_m + nt * n * 4,
            key, *outs, *args, *launch, stream)
    else:
        nt = -(-v // F32_TILE)
        f32 = dict(dtype=torch.float32, device=h.device)
        part_m = torch.empty(nt * n, **f32)
        part_s = torch.empty(nt * n, **f32)
        part_v = torch.empty(nt * n * k, **f32)
        part_i = torch.empty(nt * n * k, dtype=torch.int32, device=h.device)
        rc = lib.fused_logit_topk_launch(
            h.data_ptr(), w.data_ptr(), b.data_ptr(), part_m.data_ptr(), part_s.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), *outs, *args, stream)
    if rc != 0:
        raise RuntimeError(f"fused_logit_topk kernel launch failed: cudaError {rc}")
    fused_logit_topk.launches += 1
    return vals, idx, lse


fused_logit_topk.launches = 0


def use_fused_logit_topk(model, serving: bool, *, logits_hook=None,
                         decoding_constraint: bool = False, mesh=None) -> bool:
    """Dispatch policy of the serving beam step's vocab tail (JAX
    ``ops/fused_logit_topk.py:268-297``): the fused tail (K2 on the card)
    on the serving path of the r2gen decoder and of the port's mla_moe
    decoder (whose head has no bias: K2 reads a zero one), unless something
    needs the full [N, V] logits (``logits_hook``, ``decoding_constraint``); eval paths
    stay unfused. ``mesh``: a pure-dp mesh keeps it (each rank calls K2 on
    its rows); mp > 1 would split the [D, V] weight and declines it."""
    from evoke_tpu_torch.ops.sharding import mesh_allows_kernels

    if logits_hook is not None or decoding_constraint:
        return False
    return (serving and getattr(model, "decoder_kind", "r2gen") in ("r2gen", "mla_moe")
            and mesh_allows_kernels(mesh))
