"""Masked cross-view fusion attention (kernel K3).

Port of ``evoke_tpu/ops/fusion_attention.py`` (``masked_cross_view_attention``
/ ``_kernel``). Anchor queries q [Q, h, T, dk] attend all N = B * t_tokens
batch key rows k/v [h, N, dk]; key row r belongs to sample r // t_tokens and
is kept where ``attend_mask[q, sample]``, else its score is -1e9. Scores are
float32 from the input dtype times 1/sqrt(dk); the softmax is float32 with the
probabilities kept in float32 and V upcast for p.v; the output is
``acc / max(l, 1e-30)`` in q's dtype. This differs from the dense
``dot_attention`` path, which rounds the probabilities to V's dtype: the two
agree at float32 and differ by rounding at bf16.

``masked_cross_view_attention`` is the wrapper: a CPU tensor takes
``masked_cross_view_attention_plain``; a CUDA tensor launches
``csrc/fusion_attention.cu`` (built at first use) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_cross_view_attention_plain(q, k, v, attend_mask, t_tokens: int):
    """The plain PyTorch version: one dense float32 softmax over all N keys
    with the TPU kernel's -1e9 fill, scale multiply and float32 p.v. The
    anchors' rows are folded into one [h, Q*T, dk] operand, so k and v are
    never broadcast (copied) across anchors."""
    qn, h, t, dk = q.shape
    qf = q.float().transpose(0, 1).reshape(h, qn * t, dk)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * (1.0 / math.sqrt(dk))  # [h, QT, N]
    keep = attend_mask.bool().repeat_interleave(t_tokens, dim=1).repeat_interleave(t, dim=0)
    s = torch.where(keep[None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.clamp_min(l, 1e-30)               # [h, QT, dk]
    return out.reshape(h, qn, t, dk).transpose(0, 1).to(q.dtype)


def _check(q, k, v, attend_mask, t_tokens: int):
    if q.dim() != 4 or k.dim() != 3 or v.dim() != 3 or attend_mask.dim() != 2:
        raise ValueError(f"need q [Q, h, T, dk], k/v [h, N, dk], mask [Q, B]; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"mask {tuple(attend_mask.shape)}")
    qn, h, _, dk = q.shape
    n = k.shape[1]
    if t_tokens < 1 or n % t_tokens:
        raise ValueError(f"key rows N={n} is not a multiple of t_tokens={t_tokens}")
    if tuple(k.shape) != (h, n, dk) or tuple(v.shape) != (h, n, dk) \
            or tuple(attend_mask.shape) != (qn, n // t_tokens):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(attend_mask.shape)} "
                         f"(t_tokens={t_tokens})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: need one of "
                        "float32 / bfloat16 for all three")
    if attend_mask.dtype != torch.bool:
        raise TypeError(f"attend_mask must be bool, got {attend_mask.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("attend_mask", attend_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dimension "
                             f"(strides {t.stride()})")


@functools.cache
def _lib():
    """Build (first use), load and bind the kernel's C entry point."""
    from evoke_tpu_torch.ops import _build

    lib = _build.load("fusion_attention")
    fn = lib.fusion_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def masked_cross_view_attention(q, k, v, attend_mask, t_tokens: int,
                                key_block: int = 512):
    """q [Q, h, T, dk]; k/v [h, N, dk] (N = B * t_tokens); attend_mask [Q, B]
    bool -> [Q, h, T, dk] in q.dtype.

    Every anchor must attend at least one sample (the caller's self slot
    guarantees it; not checked, to keep the launch free of a host sync).
    ``key_block`` is kept for the JAX signature; the kernel tiles on its own
    and the output does not depend on it. q, k and v may be strided views
    with a contiguous last dimension. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (counted in
    ``masked_cross_view_attention.launches``) or raises."""
    del key_block
    if q.device.type == "cpu":
        _check(q, k, v, attend_mask, t_tokens)
        return masked_cross_view_attention_plain(q, k, v, attend_mask, t_tokens)
    if q.device.type != "cuda":
        raise ValueError(f"masked_cross_view_attention: unsupported device {q.device}")
    _check(q, k, v, attend_mask, t_tokens)
    qn, h, tq, dk = q.shape
    mask = attend_mask.contiguous().view(torch.uint8)
    out = torch.empty((qn, h, tq, dk), dtype=q.dtype, device=q.device)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                qn, h, tq, dk, attend_mask.shape[1], t_tokens,
                q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
                v.stride(0), v.stride(1), 1.0 / math.sqrt(dk), _DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"masked_cross_view_attention kernel launch failed: "
                           f"cudaError {rc}")
    masked_cross_view_attention.launches += 1
    return out


masked_cross_view_attention.launches = 0
