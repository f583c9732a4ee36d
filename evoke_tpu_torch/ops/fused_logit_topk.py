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
``csrc/fused_logit_topk.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 8
MAX_SUPPRESS = 4


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
    """Build (first use), load and bind the kernel's C entry point."""
    from evoke_tpu_torch.ops import _build

    lib = _build.load("fused_logit_topk")
    fn = lib.fused_logit_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.fused_logit_topk_tile.argtypes = []
    lib.fused_logit_topk_tile.restype = ctypes.c_int
    return fn, lib.fused_logit_topk_tile()


def fused_logit_topk(h, w, b, k: int, suppress_ids: Sequence[int] = ()):
    """h [N, D], w [V, D], b [V] (one dtype) -> (vals [N, k] f32, idx [N, k]
    i32, lse [N] f32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (counted in ``fused_logit_topk.launches``) or raises."""
    suppress_ids = tuple(int(s) for s in suppress_ids)
    if h.device.type == "cpu":
        return fused_logit_topk_plain(h, w, b, k, suppress_ids)
    if h.device.type != "cuda":
        raise ValueError(f"fused_logit_topk: unsupported device {h.device}")
    _check(h, w, b, k, suppress_ids)
    n, d = h.shape
    v = w.shape[0]
    fn, tile = _lib()
    nt = -(-v // tile)
    f32 = dict(dtype=torch.float32, device=h.device)
    part_m = torch.empty(nt * n, **f32)
    part_s = torch.empty(nt * n, **f32)
    part_v = torch.empty(nt * n * k, **f32)
    part_i = torch.empty(nt * n * k, dtype=torch.int32, device=h.device)
    vals = torch.empty(n, k, **f32)
    idx = torch.empty(n, k, dtype=torch.int32, device=h.device)
    lse = torch.empty(n, **f32)
    sup = list(suppress_ids) + [-1] * (MAX_SUPPRESS - len(suppress_ids))
    rc = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), lse.data_ptr(), n, d, v, int(k), len(suppress_ids), *sup,
            _DTYPES[h.dtype], torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_logit_topk kernel launch failed: cudaError {rc}")
    fused_logit_topk.launches += 1
    return vals, idx, lse


fused_logit_topk.launches = 0
