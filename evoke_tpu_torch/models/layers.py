"""Shared transformer building blocks (PyTorch port of evoke_tpu/models/layers.py).

Modules mirror the flax ones attribute for attribute, so a flax parameter path
``a/b/kernel`` lands on the torch key ``a.b.weight`` (``params.py``).
Numerics follow flax, not torch habit:

- ``Dense`` rounds its product to the compute dtype and THEN adds the bias in
  that dtype (flax ``nn.Dense(dtype)``), two roundings at bf16; weights are
  stored in the compute dtype, which rounds exactly as flax's per-use cast.
- ``dtype=None`` promotes to float32 the way flax does with float32 params.
- ``TorchLayerNorm``: unbiased std, eps added to the std (reference LN).
- ``LayerNorm``/``BatchNorm``: flax semantics (float32 statistics, output cast
  to the compute dtype).
- ``dot_attention``: -1e9 fill, float32 softmax, probs cast to the V dtype.

Training: every dropout site of the flax module is here with its rate, drawn
by ``dropout`` from an explicit ``torch.Generator`` passed down as ``rng``
(``rng=None`` is flax's ``deterministic=True``); ``BatchNorm(train=True)``
uses batch statistics and leaves its running update pending until
``commit_batch_stats``. Under a dp mesh (``core/mesh.use_mesh``) both
act on the global batch: BatchNorm sums its statistics over the ranks and
dropout draws the global batch's mask.

Tensor parallelism (``parallel/tp.py``): an attention block whose q / k / v
are column-split and whose output projection is row-split keeps its
attention at the rank's ``num_heads / mp`` heads (``split_heads``) when
``mp`` divides its heads; its probabilities' dropout is drawn at all heads
and the rank's kept, its recorded probabilities are gathered back to all
heads, and an int8 cache's per-slot scale is the max over the full width.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.core.mesh import active_mesh
from evoke_tpu_torch.ops.lineage_attention import lineage_attention, lineage_masks
from evoke_tpu_torch.parallel.collectives import all_gather_mp, all_reduce_sum, max_over_mp

NEG_INF = -1e9


def dropout(x, rate: float, rng, dim: int = 0, heads=None):
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), the keep mask drawn from the generator ``rng``
    on ``x``'s device. The identity when ``rng`` is None or ``rate`` is 0.

    Under an active dp mesh (``core/mesh.use_mesh``) ``x`` holds this rank's
    block of the global batch along ``dim``: the mask is drawn at the global
    shape and this rank's block kept, so every rank draws what the one-device
    step draws on the global batch, whatever the world size. ``heads``
    ``(head_dim, mesh)``: ``x`` also holds only this mp rank's block of the
    heads along ``head_dim`` (tensor parallelism); the mask is drawn at all
    heads and the rank's block kept."""
    if rng is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    shape, blocks = list(x.shape), []
    mesh = active_mesh()
    if mesh is not None and mesh.dp > 1:
        blocks.append((dim, mesh.dp_rank))
        shape[dim] *= mesh.dp
    if heads is not None and heads[1] is not None:
        blocks.append((heads[0], heads[1].mp_rank))
        shape[heads[0]] *= heads[1].mp
    u = torch.rand(shape, generator=rng, device=x.device)
    for d, r in blocks:
        u = u.narrow(d, r * x.shape[d], x.shape[d])
    mask = u < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _out_dtype(dtype, x: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``round(x @ W) + b`` in ``dtype``; weight [out, in]."""

    def __init__(self, in_features: int, out_features: int, dtype=None):
        super().__init__()
        pdt = dtype if dtype is not None else torch.float32
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=pdt))
        self.bias = nn.Parameter(torch.zeros(out_features, dtype=pdt))

    @property
    def out_width(self) -> int:
        """The width of this module's output."""
        return self.weight.shape[0]

    def forward(self, x):
        dt = self.dtype if self.dtype is not None else torch.promote_types(
            x.dtype, self.weight.dtype)
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class Embed(nn.Module):
    """flax ``nn.Embed``: a table lookup, the table cast to ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features,
                                               dtype=dtype or torch.float32))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: biased variance (E[x^2] - E[x]^2, float32),
    eps inside the rsqrt, output in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(_out_dtype(self.dtype, x))


class TorchLayerNorm(nn.Module):
    """gamma * (x - mean) / (std_unbiased + eps) + beta  (reference LayerNorm)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        d = x.shape[-1]
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).sum(-1, keepdim=True) / max(d - 1, 1)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (self.gamma * y + self.beta).to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel axis ``axis``; float32 math,
    output in ``dtype``.

    ``train=False`` normalises with the running statistics. ``train=True``
    uses the batch's biased mean and variance over every other axis, computed
    as flax does (var = E[x^2] - E[x]^2, clipped at 0), and leaves the running
    update ``ra = 0.9 * ra + 0.1 * batch`` (flax's momentum 0.9, every
    BatchNorm of the model) pending until ``commit()``: a recomputed forward
    (activation checkpointing) sets the same pending values again, so the
    update lands once a step."""

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 dtype=None, axis: int = -1):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.axis = axis
        self._pending = None
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x, train: bool = False):
        out_dt = _out_dtype(self.dtype, x)
        if train:
            return self._train_forward(x).to(out_dt)
        if self.axis in (-1, x.ndim - 1) and x.ndim != 2:
            shape = x.shape
            y = F.batch_norm(x.reshape(-1, shape[-1]).float(), self.running_mean,
                             self.running_var, self.weight, self.bias, False, 0.0,
                             self.eps).reshape(shape)
        else:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        return y.to(out_dt)

    def _train_forward(self, x):
        axis = self.axis % x.ndim
        dims = tuple(i for i in range(x.ndim) if i != axis)
        shape = [1] * x.ndim
        shape[axis] = x.shape[axis]
        xf = x.float()
        mesh = active_mesh()
        if mesh is None:
            mean = xf.mean(dims)
            var = torch.clamp_min((xf * xf).mean(dims) - mean * mean, 0.0)
        else:
            # the global batch's statistics: the sums of x and x^2 over every
            # rank's rows (differentiable, so the backward is the global one)
            sums = all_reduce_sum(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]), mesh)
            count = float(xf.numel() // xf.shape[axis] * mesh.dp)
            mean = sums[0] / count
            var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        self._pending = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y

    @torch.no_grad()
    def commit(self) -> None:
        """Apply the running update of the last training-mode forward."""
        if self._pending is None:
            return
        mean, var = self._pending
        self._pending = None
        m = self.MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)


def commit_batch_stats(module: nn.Module) -> None:
    """``commit()`` every BatchNorm under ``module`` (once per train step,
    after the backward pass)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.commit()


def dot_attention(q, k, v, mask=None, dropout_fn=None):
    """Scaled dot-product attention (layers.py:53-78); ``dropout_fn`` acts on
    the float32 probabilities.

    q: [B, h, Tq, dk], k: [B, h, Tk, dk], v: [B, h, Tk, dv]
    mask: broadcastable to [B, h, Tq, Tk]; True = attend.

    Small-Tq bf16 queries round their scores to bf16 before the float32
    softmax, as the JAX package does (its decode-step lowering); otherwise
    scores are float32-exact products (``preferred_element_type=f32``)."""
    dk = q.shape[-1]
    if k.dtype != q.dtype:        # bf16 queries over dequantized float32 caches
        ct = torch.promote_types(q.dtype, k.dtype)
        q, k = q.to(ct), k.to(ct)
    if q.shape[2] <= 4 and q.dtype == torch.bfloat16:
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(dk)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if dropout_fn is not None:
        probs = dropout_fn(probs)
    out = torch.matmul(probs.to(v.dtype), v)
    return out, probs


def split_heads(block, qkv, out, mesh) -> None:
    """Tensor parallelism: keep ``block``'s attention at this rank's
    ``num_heads / mp`` heads when ``mp`` divides its heads, its projections
    ``qkv`` (attribute names) are column-split and ``out`` is row-split; the
    projections then pass the rank's head slice straight through, and
    ``block.tp`` is the mesh. Otherwise the block keeps all heads (its split
    projections gather q / k / v and slice before ``out``). ``mesh`` None
    restores all heads (``parallel/tp.replicate_params``)."""
    heads = getattr(block, "all_heads", block.num_heads)
    block.all_heads = heads
    block.num_heads, block.tp = heads, None
    cols = [getattr(block, n) for n in qkv]
    if (mesh is None or heads % mesh.mp or not all(hasattr(c, "gather") for c in cols)
            or not hasattr(out, "scatter")):
        return
    for c in cols:
        c.gather = False
    out.scatter = False
    block.num_heads, block.tp = heads // mesh.mp, mesh


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/o projections (layers.py:81-163).

    ``record``: None (the default) keeps nothing; a list collects the float32
    probabilities [B, h, Tq, Tk] of every full-width ``attend`` (the JAX
    module's ``sow("intermediates", "attn")``), for attention heatmaps
    (``evals/heatmaps.recorded_attention``).

    ``tp``: the mesh when the block holds this rank's heads only
    (``split_heads``); ``num_heads`` is then the local count and
    ``project_kv`` returns ``kv_width`` = the local heads' width."""

    tp = None

    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        assert d_model % num_heads == 0
        self.num_heads = num_heads
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.record = None
        self.wq = Dense(d_model, d_model, dtype)
        self.wk = Dense(d_model, d_model, dtype)
        self.wv = Dense(d_model, d_model, dtype)
        self.wo = Dense(d_model, d_model, dtype)

    def split_heads_tp(self, mesh):
        split_heads(self, ("wq", "wk", "wv"), self.wo, mesh)

    @property
    def kv_width(self) -> int:
        """The width of ``project_kv``'s k and v (a cache's width)."""
        return self.wk.out_width

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, -1).transpose(1, 2)

    def _merge(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def project_kv(self, x):
        return self.wk(x), self.wv(x)

    def attend(self, q_in, k_proj, v_proj, mask=None, rng=None):
        """Attention with already-projected k/v ([Bk, Tk, D]). When q_in has
        g-times more rows than k_proj (beam-grouped queries, rows sample-major)
        each sample's g query rows attend its single K/V row directly
        (shared-KV form; ``mask`` must then be [Bk, 1, 1, Tk]; a decode form,
        without dropout). ``rng``: dropout generator of the probabilities."""
        bq, tq, _ = q_in.shape
        bk = k_proj.shape[0]
        if bq != bk:
            assert bq % bk == 0, f"query rows {bq} not a multiple of kv rows {bk}"
            g = bq // bk
            q = self.wq(q_in).reshape(bk, g * tq, self.num_heads, -1).transpose(1, 2)
            out, _ = dot_attention(q, self._split(k_proj), self._split(v_proj), mask=mask)
            return self.wo(out.transpose(1, 2).reshape(bq, tq, -1))
        q = self._split(self.wq(q_in))
        drop = None if rng is None else (
            lambda p: dropout(p, self.dropout_rate, rng, heads=(1, self.tp)))
        out, probs = dot_attention(q, self._split(k_proj), self._split(v_proj), mask=mask,
                                   dropout_fn=drop)
        if self.record is not None:
            self.record.append(all_gather_mp(probs.detach(), self.tp, 1))
        return self.wo(self._merge(out))

    def forward(self, q_in, k_in, v_in, mask=None, rng=None):
        return self.attend(q_in, self.wk(k_in), self.wv(v_in), mask=mask, rng=rng)

    def attend_lineage(self, h, cache_k, cache_v, anc, pos, age=None):
        """Ancestor-mode decode attention through the lineage kernel
        (ops/lineage_attention.py). h: [N, 1, D]; caches [N, L, D] with slot
        ``pos`` written; anc [B, kbeam, L]; age optional [N] ring ages (rows
        of a sample share their slot's age, so row 0 per sample rides in)."""
        q = self.wq(h)[:, 0, :]
        b, kbeam = anc.shape[:2]
        age_b = None if age is None else age.reshape(b, kbeam)[:, 0].contiguous()
        ctx = lineage_attention(q, cache_k, cache_v, anc, pos, self.num_heads, age=age_b)
        return self.wo(ctx[:, None, :])


def quantized_cache_update(cache, scale, new, pos: int, tp=None) -> None:
    """Write ``new`` [N, 1, D] into the int8 cache [N, L, D] at slot ``pos``,
    IN PLACE, with its per-slot absmax scale into ``scale`` [N, L] float32:
    s = max(absmax(new) / 127, 1e-8), q = round(new / s) (half to even, as
    ``jnp.round``) (layers.py:166-177). ``tp``: the mesh when ``new`` is this
    rank's heads only; the absmax is then the max over the full width (over
    the mp ranks), so every rank quantizes as one device does."""
    new32 = new[:, 0].float()
    amax = max_over_mp(new32.abs().amax(-1), tp)
    s = torch.clamp_min(amax / 127.0, 1e-8)                              # [N]
    cache[:, pos] = torch.round(new32 / s[:, None]).to(torch.int8)
    scale[:, pos] = s.to(scale.dtype)


def dequantize(cache, scale, dtype):
    """int8 [N, L, D] x per-slot scale [N, L] -> ``dtype`` (layers.py:180-187);
    the cache itself when ``scale`` is None."""
    if scale is None:
        return cache
    return cache.to(dtype) * scale[..., None].to(dtype)


def cached_self_attention(attn, h, cache_k, cache_v, pos: int, anc=None, age=None,
                          scale_k=None, scale_v=None):
    """Decode-step self-attention over the KV cache (layers.py:190-268).

    anc=None, age=None: causal read of the row's own cache (slots <= pos).
    age [N] without anc: ring caches, slot j readable iff (pos - j) mod L <= age.
    anc [B, k, L]: beam-lineage attention over un-permuted caches through
    ``attn.attend_lineage`` (the lineage kernel on the card, its plain
    version on the CPU), batch mode or, with ``age``, ring mode.
    scale_k / scale_v [N, L]: the caches are int8 (``quantized_cache_update``)
    and are dequantized to the query's dtype first."""
    if anc is not None and scale_k is None:
        return attn.attend_lineage(h, cache_k, cache_v, anc, pos, age=age)
    cache_k = dequantize(cache_k, scale_k, h.dtype)
    cache_v = dequantize(cache_v, scale_v, h.dtype)
    lmax = cache_k.shape[1]
    if anc is not None:
        # int8 caches in ancestor mode: JAX's XLA formulation (the lineage
        # kernel reads bf16 / float32 caches), every query over its sample's
        # k * L rows masked to its lineage
        b, kbeam, _ = anc.shape
        mask = lineage_masks(anc, pos, age)
        return attn.attend(h, cache_k.reshape(b, kbeam * lmax, -1),
                           cache_v.reshape(b, kbeam * lmax, -1), mask=mask)
    if age is not None:
        delta = torch.remainder(pos - torch.arange(lmax, device=h.device), lmax)
        mask = (delta[None, :] <= age[:, None])[:, None, None, :]
        return attn.attend(h, cache_k, cache_v, mask=mask)
    mask = (torch.arange(lmax, device=h.device) <= pos)[None, None, None, :]
    return attn.attend(h, cache_k, cache_v, mask=mask)


class PositionwiseFFN(nn.Module):
    """Dense -> ``activation`` (relu; the zoo's exact or tanh gelu) -> dropout
    -> Dense."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 dropout_rate: float = 0.0, activation=F.relu):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.Dense_0 = Dense(d_model, d_ff, dtype)
        self.Dense_1 = Dense(d_ff, d_model, dtype)

    def forward(self, x, rng=None):
        return self.Dense_1(dropout(self.activation(self.Dense_0(x)), self.dropout_rate, rng))


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] sine/cosine table (encoder_decoder.py:228-236)."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class TokenEmbed(nn.Module):
    """Embedding * sqrt(d_model) + sinusoidal PE. The PE table is float32, so
    a bf16 embedding promotes the output (the decoder's residual stream) to
    float32, as in the JAX package."""

    def __init__(self, vocab_size: int, d_model: int, max_len: int = 5000,
                 dtype=torch.float32, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model = d_model
        self.dropout_rate = dropout_rate
        self.lut = Embed(vocab_size, d_model, dtype)
        self.register_buffer("pe", torch.tensor(sinusoidal_pe(max_len, d_model)),
                             persistent=False)

    def forward(self, ids, rng=None):
        """ids [B, T] -> [B, T, D] with the PE of positions 0..T-1."""
        x = self.lut(ids) * math.sqrt(self.d_model) + self.pe[None, : ids.shape[1]]
        return dropout(x, self.dropout_rate, rng)

    def at_position(self, ids, pos: int, age=None):
        """ids: [B], pos: step -> [B, 1, D]; age [B]: per-row PE positions."""
        x = self.lut(ids)[:, None, :] * math.sqrt(self.d_model)
        if age is not None:
            return x + self.pe[age.long()][:, None, :]
        return x + self.pe[pos:pos + 1][None]


def causal_mask(t: int, device=None):
    """[1, 1, t, t] lower-triangular boolean mask."""
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()[None, None]


def make_self_mask(pad_mask, causal: bool = False):
    """pad_mask: [B, T] (1 = token) -> [B, 1, 1, T] mask over keys, or with
    ``causal`` [B, 1, T, T]."""
    m = pad_mask[:, None, None, :].bool()
    if causal:
        m = m & causal_mask(pad_mask.shape[-1], pad_mask.device)
    return m


def make_cross_mask(kv_pad_mask):
    """kv_pad_mask: [B, Tk] -> [B, 1, 1, Tk]."""
    return kv_pad_mask[:, None, None, :].bool()


class BertSelfOutput(nn.Module):
    """Dense + post-LN residual (HF Bert*Output contract, LN eps 1e-12)."""

    def __init__(self, in_features: int, hidden_size: int, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Dense_0 = Dense(in_features, hidden_size, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)

    def forward(self, hidden, residual, rng=None):
        h = dropout(self.Dense_0(hidden), self.dropout_rate, rng)
        return self.LayerNorm_0(h + residual)


class BertAttentionBlock(nn.Module):
    """HF BertAttention: MHA (no output projection inside) + BertSelfOutput."""

    tp = None

    def __init__(self, hidden_size: int, num_heads: int, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.wq = Dense(d, d, dtype)
        self.wk = Dense(d, d, dtype)
        self.wv = Dense(d, d, dtype)
        self.out = BertSelfOutput(d, d, dtype, dropout_rate)

    def split_heads_tp(self, mesh):
        split_heads(self, ("wq", "wk", "wv"), self.out.Dense_0, mesh)

    @property
    def kv_width(self) -> int:
        return self.wk.out_width

    def project_kv(self, x):
        return self.wk(x), self.wv(x)

    def attend(self, x, k_proj, v_proj, mask=None, rng=None):
        b, tq, _ = x.shape
        h = self.num_heads
        bk = k_proj.shape[0]
        assert b % bk == 0, f"query rows {b} not a multiple of kv rows {bk}"
        q = self.wq(x).reshape(bk, (b // bk) * tq, h, -1).transpose(1, 2)
        k = k_proj.reshape(bk, k_proj.shape[1], h, -1).transpose(1, 2)
        v = v_proj.reshape(bk, v_proj.shape[1], h, -1).transpose(1, 2)
        drop = None if rng is None else (
            lambda p: dropout(p, self.dropout_rate, rng, heads=(1, self.tp)))
        ctx, _ = dot_attention(q, k, v, mask=mask, dropout_fn=drop)
        ctx = ctx.transpose(1, 2).reshape(b, tq, -1)
        return self.out(ctx, x, rng)

    def forward(self, x, kv, mask=None, rng=None):
        k, v = self.project_kv(kv)
        return self.attend(x, k, v, mask=mask, rng=rng)

    def attend_lineage(self, x, cache_k, cache_v, anc, pos, age=None):
        """Lineage-kernel attention + this block's post-LN residual output."""
        q = self.wq(x)[:, 0, :]
        ctx = lineage_attention(q, cache_k, cache_v, anc, pos, self.num_heads, age=age)
        return self.out(ctx[:, None, :], x)


class BertFFNBlock(nn.Module):
    """HF BertIntermediate + BertOutput (exact gelu, post-LN residual)."""

    def __init__(self, hidden_size: int, intermediate_size: int, dtype=torch.float32,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.Dense_0 = Dense(hidden_size, intermediate_size, dtype)
        self.BertSelfOutput_0 = BertSelfOutput(intermediate_size, hidden_size, dtype,
                                               dropout_rate)

    def forward(self, x, rng=None):
        h = F.gelu(self.Dense_0(x), approximate="none")
        return self.BertSelfOutput_0(h, x, rng)


class BertLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.attention = BertAttentionBlock(hidden_size, num_heads, dtype, dropout_rate)
        self.ffn = BertFFNBlock(hidden_size, intermediate_size, dtype, dropout_rate)

    def forward(self, x, mask=None, rng=None):
        return self.ffn(self.attention(x, x, mask=mask, rng=rng), rng)


class BertCrossLayer(nn.Module):
    """Self-attn -> cross-attn -> FFN (reference BertCrossLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.attention = BertAttentionBlock(hidden_size, num_heads, dtype, dropout_rate)
        self.crossattention = BertAttentionBlock(hidden_size, num_heads, dtype, dropout_rate)
        self.ffn = BertFFNBlock(hidden_size, intermediate_size, dtype, dropout_rate)

    def forward(self, x, enc, self_mask=None, cross_mask=None, rng=None):
        x = self.attention(x, x, mask=self_mask, rng=rng)
        x = self.crossattention(x, enc, mask=cross_mask, rng=rng)
        return self.ffn(x, rng)

    def prepare_cross_kv(self, enc):
        return self.crossattention.project_kv(enc)

    def step(self, x, cross_k, cross_v, cross_mask, cache_k, cache_v, pos: int, anc=None):
        """One-token decode step (layers.py:480-498): x [N, 1, D]; caches
        [N, L, D] written at ``pos`` in place; anc optional [B, k, L] (the
        lineage route is ``BertAttentionBlock.attend_lineage``)."""
        k_new, v_new = self.attention.project_kv(x)
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
        x = cached_self_attention(self.attention, x, cache_k, cache_v, pos, anc)
        x = self.crossattention.attend(x, cross_k, cross_v, mask=cross_mask)
        return self.ffn(x), cache_k, cache_v
