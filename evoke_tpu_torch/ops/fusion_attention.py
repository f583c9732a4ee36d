"""Masked cross-view fusion attention (kernel K3).

Port of ``evoke_tpu/ops/fusion_attention.py`` (``masked_cross_view_attention``
/ ``_kernel``). Anchor queries q [Q, h, T, dk] attend all N = B * t_tokens
batch key rows k/v [h, N, dk]; key row r belongs to sample r // t_tokens and
is kept where ``attend_mask[q, sample]``, else its score is -1e9. Scores are
float32 from the input dtype times 1/sqrt(dk); the softmax is float32 with the
probabilities kept in float32; the output is ``acc / max(l, 1e-30)`` in q's
dtype. This differs from the dense ``dot_attention`` path, which rounds the
probabilities to V's dtype: the two agree at float32 and differ by rounding
at bf16.

``masked_cross_view_attention`` is the wrapper: a CPU tensor takes
``masked_cross_view_attention_plain``; a CUDA tensor launches
``csrc/fusion_attention.cu`` (built at first use) or raises.

The kernel replaces a first design in which each of the 8 blocks of one
(anchor, head) at dk 2048 recomputed the whole score tile and ran p.v as
float32 FMA. The work is bound by bytes (q, the attended k and v rows and the
output, once each), 10x above its operations at bf16, so the design
(``launch_plan``'s "cluster" route) reads each byte once and hides the
arithmetic: the blocks of one (anchor, head, 64-row tile) form a thread-block
cluster, each holds its own dk chunk of q, k and v, the partial score tiles
are summed through distributed shared memory by the block that owns the rows,
which runs the online softmax and hands the probabilities back (one such
exchange per pair of 32-key tiles); p.v runs on the tensor cores with the
float32 probability split into two bf16 terms against V in its own dtype
(``split_probability``); k and v tiles arrive by 16-byte asynchronous copies
into a ring of three tiles. ``cluster_order``
is that order of work written in PyTorch. Rows that are not 16-byte aligned,
and dk above 8 chunks, take the first design's kernel (the "recompute"
route), on the card as well.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e9
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 64              # query rows per block
SMEM_LIMIT = 232448    # bytes of shared memory a block may use on Hopper (227 KB)
MAX_CLUSTER = 8        # the portable cluster size
LIST_CAP = 256         # attended samples compacted at a time
KEY_TILE = 32          # keys of one k or v tile
GROUP_KEYS = 64        # keys of one exchange across the cluster: a pair of tiles
WARPS = 8
_ROUTES = {"recompute": 0, "cluster": 1}
SM_SMEM = 233472       # shared memory of one SM (228 KB); each block reserves 1 KB more
BLOCK_RESERVED = 1024
CLUSTER_CHUNKS = (128, 256)   # columns a block of the cluster route: the narrowest that fits


def cluster_smem_bytes(chunk: int, dtype, tq: int, cluster: int) -> int:
    """The cluster route's dynamic shared memory, region by region as
    ``csrc/fusion_attention.cu`` lays it out (its ``Layout``): q's slice
    (min(64, T) rows), a ring of three k or v tiles (rows padded by 16 bytes),
    the received score strips ([cluster * rows a block owns][64 keys]
    float32), the float32 probabilities (rows padded by 32 bytes), the softmax
    state (corr, l received; m, l owned), the sample list, the per-warp
    counts, two mbarriers."""
    isz = 4 if dtype == torch.float32 else 2
    ldb = chunk * isz + 16
    rpc = -(-ROWS // cluster)
    return (min(ROWS, tq) * ldb + 3 * KEY_TILE * ldb + cluster * rpc * GROUP_KEYS * 4
            + ROWS * (GROUP_KEYS + 8) * 4 + 4 * ROWS * 4 + LIST_CAP * 4 + 64 + 16)


def recompute_smem_bytes(dtype) -> int:
    """The recompute route's dynamic shared memory: float32 scores [64][68],
    a float32 V tile [64][256], m / l / corr, and one 64-wide q and k slice."""
    ld, isz = (65, 4) if dtype == torch.float32 else (72, 2)
    return ROWS * 68 * 4 + 64 * 256 * 4 + 3 * ROWS * 4 + 2 * ROWS * ld * isz


def launch_plan(tq: int, dk: int, dtype, aligned: bool = True) -> dict:
    """The kernel's launch for q [Q, h, tq, dk] of ``dtype``.

    ``route`` "cluster": the narrowest chunk of 128 or 256 columns that covers
    dk in at most 8 blocks (``cluster`` = ceil(dk / chunk) blocks form one
    thread-block cluster per (anchor, head, 64-row tile); grid (Q * cluster, h,
    row tiles)). It needs ``aligned``: every row of q, k and v starts on a
    16-byte boundary and dk is a multiple of 16 bytes. ``route`` "recompute"
    (the first design: grid (Q, h, 256-column chunks x row tiles), scalar
    loads, scores recomputed per chunk) takes the rest: unaligned rows, and dk
    above 8 chunks. ``key_tile`` is the keys of one k or v tile, ``group_keys``
    the keys of one exchange across the cluster (a pair of tiles), ``stages``
    the tiles of the k / v ring, ``blocks_per_sm`` the blocks that share an SM
    by shared memory (the cluster route's kernel is compiled for 2 at bf16
    and for 1 at float32)."""
    if tq < 1 or dk < 1 or dtype not in _DTYPES:
        raise ValueError(f"launch_plan: T {tq} (>= 1), dk {dk} (>= 1), dtype {dtype} "
                         "(float32 / bfloat16)")
    row_tiles = -(-tq // ROWS)
    fits = [c for c in CLUSTER_CHUNKS if -(-dk // c) <= MAX_CLUSTER]
    if aligned and fits and row_tiles <= 65535:
        ch = fits[0]
        cluster = -(-dk // ch)
        smem = cluster_smem_bytes(ch, dtype, tq, cluster)
        compiled_for = 2 if dtype == torch.bfloat16 else 1
        return dict(route="cluster", chunk=ch, cluster=cluster, key_tile=KEY_TILE,
                    group_keys=GROUP_KEYS, stages=3, warps=WARPS, threads=WARPS * 32,
                    row_tiles=row_tiles, rows_per_block=-(-ROWS // cluster), smem_bytes=smem,
                    blocks_per_sm=min(SM_SMEM // (smem + BLOCK_RESERVED), compiled_for),
                    grid_per_anchor=(cluster, row_tiles))
    chunks = -(-dk // 256)
    if chunks * row_tiles > 65535:
        raise ValueError(f"masked_cross_view_attention: T {tq} x dk {dk} needs "
                         f"{chunks * row_tiles} blocks per (anchor, head); the grid takes 65535")
    smem = recompute_smem_bytes(dtype)
    return dict(route="recompute", chunk=256, cluster=1, key_tile=64, group_keys=64, stages=1,
                warps=8, threads=256, row_tiles=row_tiles, rows_per_block=ROWS,
                smem_bytes=smem, blocks_per_sm=SM_SMEM // (smem + BLOCK_RESERVED),
                grid_per_anchor=(1, chunks * row_tiles))


def split_probability(p):
    """The two bf16 terms that carry a float32 probability into the tensor
    cores: hi = bf16(p), lo = bf16(p - hi). hi + lo differs from p by at most
    2^-16 |p| (each rounding keeps 8 bits)."""
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    return hi, lo


def cluster_order(q, k, v, attend_mask, t_tokens: int, chunk: int = 256,
                  key_tile: Optional[int] = None, split: Optional[bool] = None):
    """The cluster route's order of work in PyTorch (any device): per anchor
    and 64-row query tile, over the attended samples' exchanges (``key_tile``
    keys each: the kernel's pair of 32-key tiles) in order, the
    partial scores of each dk chunk summed chunk by chunk, the online softmax
    with the kernel's -1e9 start, and p.v per chunk; at bf16 p enters as its
    ``split_probability`` terms against V in bf16 with float32 sums
    (``split`` forces that on or off)."""
    qn, h, t, dk = q.shape
    bf = q.dtype == torch.bfloat16 if split is None else split
    kt = key_tile or GROUP_KEYS
    scale = 1.0 / math.sqrt(dk)
    out = torch.empty((qn, h, t, dk), dtype=q.dtype, device=q.device)
    cols = [(c, min(c + chunk, dk)) for c in range(0, dk, chunk)]
    for qi in range(qn):
        samples = torch.nonzero(attend_mask[qi]).flatten().tolist()
        for r0 in range(0, t, ROWS):
            qt = q[qi, :, r0:r0 + ROWS].float()                           # [h, rows, dk]
            rows = qt.shape[1]
            m = torch.full((h, rows, 1), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((h, rows, dk), dtype=torch.float32, device=q.device)
            for j in samples:
                for k0 in range(j * t_tokens, (j + 1) * t_tokens, kt):
                    k1 = min(k0 + kt, (j + 1) * t_tokens)
                    s = torch.zeros((h, rows, k1 - k0), dtype=torch.float32, device=q.device)
                    for a, b in cols:     # one block's partial tile, summed in block order
                        s = s + torch.matmul(qt[..., a:b], k[:, k0:k1, a:b].float()
                                             .transpose(-1, -2))
                    s = s * scale
                    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    p = torch.exp(s - m_new)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(dim=-1, keepdim=True)
                    m = m_new
                    vt = v[:, k0:k1].float()
                    if bf:
                        hi, lo = split_probability(p)
                        pv = torch.matmul(hi.float(), vt) + torch.matmul(lo.float(), vt)
                    else:
                        pv = torch.matmul(p, vt)
                    acc = acc * corr + pv
            out[qi, :, r0:r0 + ROWS] = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


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


def bind(lib: ctypes.CDLL):
    """The C entry point of a loaded ``csrc/fusion_attention.cu``."""
    fn = lib.fusion_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _lib():
    """Build (first use), load and bind the kernel."""
    from evoke_tpu_torch.ops import _build

    return bind(_build.load("fusion_attention"))


@functools.lru_cache(maxsize=64)
def _plan(tq: int, dk: int, dtype, aligned: bool) -> Tuple[int, int, int, int, int, int]:
    """``launch_plan``'s launch arguments, once per shape: route, chunk,
    cluster size, keys per tile, warps, dynamic shared-memory bytes."""
    p = launch_plan(tq, dk, dtype, aligned)
    return (_ROUTES[p["route"]], p["chunk"], p["cluster"], p["key_tile"], p["warps"],
            p["smem_bytes"])


def _aligned(q, k, v) -> bool:
    """Whether every row of q, k and v starts on a 16-byte boundary and dk is
    a whole number of 16-byte granules (what the cluster route's loads need)."""
    epg = 16 // q.element_size()
    return (q.shape[-1] % epg == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and all(s % epg == 0 for t in (q, k, v) for s in t.stride()[:-1]))


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
                *_plan(tq, dk, q.dtype, _aligned(q, k, v)),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("masked_cross_view_attention: the launch plan disagrees with "
                           "the kernel's layout" if rc == -1 else
                           f"masked_cross_view_attention kernel launch failed: cudaError {rc}")
    masked_cross_view_attention.launches += 1
    return out


masked_cross_view_attention.launches = 0
