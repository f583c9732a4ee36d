"""Beam-lineage self-attention over un-permuted KV caches (kernel K1).

Port of ``evoke_tpu/ops/lineage_attention.py`` (``_lineage_call`` /
``_kernel``). Query row (s, b) attends physical row j of its own sample at
slot t iff ``anc[s, b, t] == j`` and ``0 < (pos - t) mod L <= age``, plus its
own row at slot ``pos``. Scores and softmax are float32, the probabilities
are rounded to the V dtype, the weighted sum accumulates in float32; the
result is the context before ``wo``. Batch mode has age = pos; ring mode has a
per-sample ``age`` [B].

``lineage_attention`` is the wrapper: a CPU tensor takes
``lineage_attention_plain``; a CUDA tensor launches
``csrc/lineage_attention.cu`` (built at first use) or raises. The kernel's
shared memory is sized by ``launch_plan``; ``attended_rows`` is the content
of the compact row list the kernel builds.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
THREADS = 256          # one block per (sample, head)
WARPS = THREADS // 32
STATIC_SMEM = 192      # the kernel's static shared memory (per-warp counts and maxima)
SMEM_LIMIT = 232448    # bytes of shared memory a block may use on Hopper (227 KB)
SM_SMEM = 233472       # shared memory of one SM (228 KB); each block reserves 1 KB more
BLOCK_RESERVED = 1024


def _align16(x: int) -> int:
    return (x + 15) & ~15


def launch_plan(kbeam: int, lmax: int, dh: int, dtype) -> dict:
    """The kernel's launch for anc [B, kbeam, lmax], head dim ``dh`` and cache
    dtype ``dtype``: 16-byte loads (``lanes_per_row`` lanes cover one row's dh
    slice, so one load instruction of a warp covers ``rows_per_load`` rows and
    a warp keeps ``rows_in_flight`` rows in flight), and the dynamic shared
    memory's regions in their order: the V tile [v_rows][dh], the float32
    scores [kbeam][kbeam * lmax], the compact row list [kbeam * lmax] int32,
    the P.V partials [warps][kbeam][dh] float32.

    The tile holds every row when that fits; else the rows that fit, and the
    kernel reads the attended rows beyond it from device memory. Where not
    even the list fits, ``compact`` is False: no list, no tile, rows walked in
    place. ``csrc/lineage_attention.cu`` takes ``v_rows``, ``compact`` and
    ``smem_bytes`` from here and refuses a plan whose bytes disagree with its
    own layout. ``blocks_per_sm`` counts shared memory and threads; the
    kernel's register cap (64 a thread) leaves room for 4."""
    if not 1 <= kbeam <= 4 or lmax < 1 or dh not in _HEAD_DIMS or dtype not in _DTYPES:
        raise ValueError(f"launch_plan: kbeam {kbeam} (1..4), L {lmax} (>= 1), head dim "
                         f"{dh} {_HEAD_DIMS}, dtype {dtype} (float32 / bfloat16)")
    isz = 4 if dtype == torch.float32 else 2
    rows = kbeam * lmax
    lanes_per_row = dh * isz // 16
    rows_per_load = 32 // lanes_per_row
    # independent 16-byte K loads a lane starts before it uses one: 4, or 2 where
    # q alone takes 32 registers (bf16 at beam 4) under the 64-register cap
    loads = 2 if kbeam * (16 // isz) >= 32 else 4
    score_bytes = _align16(kbeam * rows * 4)
    part_bytes = WARPS * kbeam * dh * 4
    list_bytes = _align16(rows * 4)
    room = SMEM_LIMIT - STATIC_SMEM - score_bytes - part_bytes
    if room < 0:
        raise ValueError(f"lineage_attention: kbeam {kbeam} x L {lmax} needs "
                         f"{score_bytes + part_bytes + STATIC_SMEM} bytes of shared memory "
                         f"for its scores and partials; a block has {SMEM_LIMIT}")
    compact = room >= list_bytes
    if compact:
        v_rows = min(rows, (room - list_bytes) // (dh * isz))
    else:
        list_bytes, v_rows = 0, 0
    v_bytes = v_rows * dh * isz
    smem_bytes = v_bytes + score_bytes + list_bytes + part_bytes
    per_block = smem_bytes + STATIC_SMEM + BLOCK_RESERVED
    return dict(threads=THREADS, warps=WARPS, lanes_per_row=lanes_per_row,
                rows_per_load=rows_per_load, loads_in_flight=loads,
                rows_in_flight=loads * rows_per_load, compact=compact,
                v_rows=v_rows, v_bytes=v_bytes, score_bytes=score_bytes,
                list_bytes=list_bytes, part_bytes=part_bytes, smem_bytes=smem_bytes,
                blocks_per_sm=min(SM_SMEM // per_block, 2048 // THREADS))


def attended_rows(anc, pos: int, age=None):
    """[B, kbeam*L] bool: the key rows (physical beam j, slot t) -> j*L + t that
    at least one query of the sample attends. Its nonzero indices, ascending,
    are the compact list the kernel builds per sample; only these rows of K
    and V are read. Row (j, t) is attended iff t == pos (query j's own row),
    or slot t is in the window and some lineage passes through j there."""
    b, kbeam, lmax = anc.shape
    t = torch.arange(lmax, device=anc.device)
    delta = torch.where(pos - t < 0, pos - t + lmax, pos - t)              # [L]
    age_b = (torch.full((b,), pos, device=anc.device) if age is None
             else age.to(anc.device))
    hist = (delta > 0)[None, :] & (delta[None, :] <= age_b[:, None])       # [B, L]
    need = torch.zeros(b, kbeam, lmax, dtype=torch.bool, device=anc.device)
    need.scatter_(1, anc.long(), hist[:, None, :].expand(b, kbeam, lmax))
    need[:, :, pos] = True
    return need.reshape(b, kbeam * lmax)


def lineage_masks(anc, pos: int, age=None):
    """[B, 1, kbeam, kbeam*L] bool: the attended set of each query row, keys
    flattened (physical beam j, slot t) -> j*L + t (layers.py:251-268 in its
    ring form; age=None is batch mode, age = pos)."""
    b, kbeam, lmax = anc.shape
    t = torch.arange(lmax, device=anc.device)
    delta = torch.remainder(pos - t, lmax)                                 # [L]
    age_b = (torch.full((b,), pos, device=anc.device) if age is None
             else age.to(anc.device))
    hist_t = ((delta > 0)[None, :] & (delta[None, :] <= age_b[:, None]))[:, None, :, None]
    now_t = (delta == 0)[None, :, None]                                    # [1, t', 1]
    hist = F.one_hot(anc.long(), kbeam).bool() & hist_t                    # [B, q, t', j]
    self_now = torch.eye(kbeam, dtype=torch.bool, device=anc.device)[:, None, :] & now_t
    mask = (hist | self_now[None]).permute(0, 1, 3, 2)                     # [B, q, j, t']
    return mask.reshape(b, 1, kbeam, kbeam * lmax)


def lineage_attention_plain(q, cache_k, cache_v, anc, pos: int, num_heads: int,
                            age=None):
    """The plain PyTorch version: the ancestor formulation with float32
    scores, as the TPU kernel keeps them (scale multiplies, as the kernel)."""
    n, d = q.shape
    b, kbeam, lmax = anc.shape
    dh = d // num_heads
    mask = lineage_masks(anc, pos, age)
    qh = q.reshape(b, kbeam, num_heads, dh).transpose(1, 2)                # [B, h, k, dh]
    kh = cache_k.reshape(b, kbeam * lmax, num_heads, dh).transpose(1, 2)   # [B, h, kL, dh]
    vh = cache_v.reshape(b, kbeam * lmax, num_heads, dh).transpose(1, 2)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * (1.0 / math.sqrt(dh))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(n, d).to(q.dtype)


def _check(q, cache_k, cache_v, anc, pos, num_heads, age):
    n, d = q.shape
    if anc.dim() != 3:
        raise ValueError(f"anc must be [B, kbeam, L], got {tuple(anc.shape)}")
    b, kbeam, lmax = anc.shape
    if n != b * kbeam or tuple(cache_k.shape) != (n, lmax, d) \
            or tuple(cache_v.shape) != (n, lmax, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, cache_k "
                         f"{tuple(cache_k.shape)}, cache_v {tuple(cache_v.shape)}, "
                         f"anc {tuple(anc.shape)}")
    if d % num_heads or d // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {d}/{num_heads} not in {_HEAD_DIMS}")
    if not 1 <= kbeam <= 4:
        raise ValueError(f"kbeam {kbeam} outside 1..4")
    if q.dtype not in _DTYPES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {cache_k.dtype}, v {cache_v.dtype}: "
                        "need one of float32 / bfloat16 for all three")
    if anc.dtype != torch.int32 or (age is not None and age.dtype != torch.int32):
        raise TypeError("anc and age must be int32")
    if age is not None and tuple(age.shape) != (b,):
        raise ValueError(f"age must be [B={b}], got {tuple(age.shape)}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v), ("anc", anc),
                    ("age", age)):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")
    if q.data_ptr() % 16 or cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16:
        raise ValueError("q, cache_k and cache_v must be 16-byte aligned (vector loads)")
    if not 0 <= pos < lmax:
        raise ValueError(f"pos {pos} outside the cache's slots [0, {lmax})")


def bind(lib: ctypes.CDLL):
    """The C entry point of a loaded ``csrc/lineage_attention.cu``."""
    fn = lib.lineage_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib():
    """Build (first use), load and bind the kernel."""
    from evoke_tpu_torch.ops import _build

    return bind(_build.load("lineage_attention"))


@functools.lru_cache(maxsize=64)
def _plan(kbeam: int, lmax: int, dh: int, dtype) -> Tuple[int, int, int]:
    """``launch_plan``'s launch arguments, once per shape: V tile rows,
    whether the rows are compacted, dynamic shared-memory bytes."""
    p = launch_plan(kbeam, lmax, dh, dtype)
    return p["v_rows"], int(p["compact"]), p["smem_bytes"]


def lineage_attention(q, cache_k, cache_v, anc, pos: int, num_heads: int,
                      age: Optional[torch.Tensor] = None):
    """q [N, D], caches [N, L, D] (slot ``pos`` written), anc [B, kbeam, L]
    int32, age optional [B] int32 -> context [N, D] in q.dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``lineage_attention.launches``) or raises."""
    if q.device.type == "cpu":
        return lineage_attention_plain(q, cache_k, cache_v, anc, pos, num_heads, age)
    if q.device.type != "cuda":
        raise ValueError(f"lineage_attention: unsupported device {q.device}")
    pos = int(pos)
    _check(q, cache_k, cache_v, anc, pos, num_heads, age)
    d = q.shape[1]
    b, kbeam, lmax = anc.shape
    dh = d // num_heads
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), anc.data_ptr(),
                0 if age is None else age.data_ptr(), out.data_ptr(),
                b, kbeam, lmax, d, num_heads, pos, 1.0 / math.sqrt(dh),
                _DTYPES[q.dtype], *_plan(kbeam, lmax, dh, q.dtype),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("lineage_attention: the launch plan disagrees with the kernel's "
                           "layout" if rc == -1 else
                           f"lineage_attention kernel launch failed: cudaError {rc}")
    lineage_attention.launches += 1
    return out


lineage_attention.launches = 0
