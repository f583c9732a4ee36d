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
``csrc/lineage_attention.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


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


def _check(q, cache_k, cache_v, anc, num_heads, age):
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


@functools.cache
def _lib():
    """Build (first use), load and bind the kernel's C entry point."""
    from evoke_tpu_torch.ops import _build

    lib = _build.load("lineage_attention")
    fn = lib.lineage_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    _check(q, cache_k, cache_v, anc, num_heads, age)
    n, d = q.shape
    b, kbeam, lmax = anc.shape
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), anc.data_ptr(),
                0 if age is None else age.data_ptr(), out.data_ptr(),
                b, kbeam, lmax, d, num_heads, int(pos), 1.0 / math.sqrt(d // num_heads),
                _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lineage_attention kernel launch failed: cudaError {rc}")
    lineage_attention.launches += 1
    return out


lineage_attention.launches = 0
