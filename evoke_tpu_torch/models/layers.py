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
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.ops.lineage_attention import lineage_attention

NEG_INF = -1e9


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
    """flax ``nn.BatchNorm`` in inference mode (running statistics), over the
    channel axis ``axis``; float32 math, output in ``dtype``. Training-mode
    statistics are ROADMAP A10."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 dtype=None, axis: int = -1):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.axis = axis
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        out_dt = _out_dtype(self.dtype, x)
        if self.axis in (-1, x.ndim - 1) and x.ndim != 2:
            shape = x.shape
            y = F.batch_norm(x.reshape(-1, shape[-1]).float(), self.running_mean,
                             self.running_var, self.weight, self.bias, False, 0.0,
                             self.eps).reshape(shape)
        else:
            y = F.batch_norm(x.float(), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        return y.to(out_dt)


def dot_attention(q, k, v, mask=None):
    """Scaled dot-product attention (layers.py:53-78).

    q: [B, h, Tq, dk], k: [B, h, Tk, dk], v: [B, h, Tk, dv]
    mask: broadcastable to [B, h, Tq, Tk]; True = attend.

    Small-Tq bf16 queries round their scores to bf16 before the float32
    softmax, as the JAX package does (its decode-step lowering); otherwise
    scores are float32-exact products (``preferred_element_type=f32``)."""
    dk = q.shape[-1]
    if q.shape[2] <= 4 and q.dtype == torch.bfloat16:
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
    else:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(dk)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out, probs


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/o projections (layers.py:81-163)."""

    def __init__(self, num_heads: int, d_model: int, dtype=torch.float32):
        super().__init__()
        assert d_model % num_heads == 0
        self.num_heads = num_heads
        self.d_model = d_model
        self.wq = Dense(d_model, d_model, dtype)
        self.wk = Dense(d_model, d_model, dtype)
        self.wv = Dense(d_model, d_model, dtype)
        self.wo = Dense(d_model, d_model, dtype)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_heads, -1).transpose(1, 2)

    def _merge(self, x):
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def project_kv(self, x):
        return self.wk(x), self.wv(x)

    def attend(self, q_in, k_proj, v_proj, mask=None):
        """Attention with already-projected k/v ([Bk, Tk, D]). When q_in has
        g-times more rows than k_proj (beam-grouped queries, rows sample-major)
        each sample's g query rows attend its single K/V row directly
        (shared-KV form; ``mask`` must then be [Bk, 1, 1, Tk])."""
        bq, tq, _ = q_in.shape
        bk = k_proj.shape[0]
        if bq != bk:
            assert bq % bk == 0, f"query rows {bq} not a multiple of kv rows {bk}"
            g = bq // bk
            q = self.wq(q_in).reshape(bk, g * tq, self.num_heads, -1).transpose(1, 2)
            out, _ = dot_attention(q, self._split(k_proj), self._split(v_proj), mask=mask)
            return self.wo(out.transpose(1, 2).reshape(bq, tq, -1))
        q = self._split(self.wq(q_in))
        out, _ = dot_attention(q, self._split(k_proj), self._split(v_proj), mask=mask)
        return self.wo(self._merge(out))

    def forward(self, q_in, k_in, v_in, mask=None):
        return self.attend(q_in, self.wk(k_in), self.wv(v_in), mask=mask)

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


def cached_self_attention(attn, h, cache_k, cache_v, pos: int, anc=None, age=None):
    """Decode-step self-attention over the KV cache (layers.py:190-268).

    anc=None, age=None: causal read of the row's own cache (slots <= pos).
    age [N] without anc: ring caches, slot j readable iff (pos - j) mod L <= age.
    anc [B, k, L]: beam-lineage attention over un-permuted caches through
    ``attn.attend_lineage`` (the lineage kernel on the card, its plain
    version on the CPU), batch mode or, with ``age``, ring mode. The int8
    cache branch is ROADMAP A12a."""
    if age is not None and anc is None:
        lmax = cache_k.shape[1]
        delta = torch.remainder(pos - torch.arange(lmax, device=h.device), lmax)
        mask = (delta[None, :] <= age[:, None])[:, None, None, :]
        return attn.attend(h, cache_k, cache_v, mask=mask)
    if anc is not None:
        return attn.attend_lineage(h, cache_k, cache_v, anc, pos, age=age)
    lmax = cache_k.shape[1]
    mask = (torch.arange(lmax, device=h.device) <= pos)[None, None, None, :]
    return attn.attend(h, cache_k, cache_v, mask=mask)


class PositionwiseFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(d_model, d_ff, dtype)
        self.Dense_1 = Dense(d_ff, d_model, dtype)

    def forward(self, x):
        return self.Dense_1(F.relu(self.Dense_0(x)))


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
                 dtype=torch.float32):
        super().__init__()
        self.d_model = d_model
        self.lut = Embed(vocab_size, d_model, dtype)
        self.register_buffer("pe", torch.tensor(sinusoidal_pe(max_len, d_model)),
                             persistent=False)

    def at_position(self, ids, pos: int, age=None):
        """ids: [B], pos: step -> [B, 1, D]; age [B]: per-row PE positions."""
        x = self.lut(ids)[:, None, :] * math.sqrt(self.d_model)
        if age is not None:
            return x + self.pe[age.long()][:, None, :]
        return x + self.pe[pos:pos + 1][None]


def make_self_mask(pad_mask):
    """pad_mask: [B, T] (1 = token) -> [B, 1, 1, T] mask over keys (the causal
    form serves training, ROADMAP A10)."""
    return pad_mask[:, None, None, :].bool()


def make_cross_mask(kv_pad_mask):
    """kv_pad_mask: [B, Tk] -> [B, 1, 1, Tk]."""
    return kv_pad_mask[:, None, None, :].bool()


class BertSelfOutput(nn.Module):
    """Dense + post-LN residual (HF Bert*Output contract, LN eps 1e-12)."""

    def __init__(self, in_features: int, hidden_size: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_features, hidden_size, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)

    def forward(self, hidden, residual):
        return self.LayerNorm_0(self.Dense_0(hidden) + residual)


class BertAttentionBlock(nn.Module):
    """HF BertAttention: MHA (no output projection inside) + BertSelfOutput."""

    def __init__(self, hidden_size: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        d = hidden_size
        self.num_heads = num_heads
        self.wq = Dense(d, d, dtype)
        self.wk = Dense(d, d, dtype)
        self.wv = Dense(d, d, dtype)
        self.out = BertSelfOutput(d, d, dtype)

    def project_kv(self, x):
        return self.wk(x), self.wv(x)

    def attend(self, x, k_proj, v_proj, mask=None):
        b, tq, _ = x.shape
        h = self.num_heads
        bk = k_proj.shape[0]
        assert b % bk == 0, f"query rows {b} not a multiple of kv rows {bk}"
        q = self.wq(x).reshape(bk, (b // bk) * tq, h, -1).transpose(1, 2)
        k = k_proj.reshape(bk, k_proj.shape[1], h, -1).transpose(1, 2)
        v = v_proj.reshape(bk, v_proj.shape[1], h, -1).transpose(1, 2)
        ctx, _ = dot_attention(q, k, v, mask=mask)
        ctx = ctx.transpose(1, 2).reshape(b, tq, -1)
        return self.out(ctx, x)

    def forward(self, x, kv, mask=None):
        k, v = self.project_kv(kv)
        return self.attend(x, k, v, mask=mask)

    def attend_lineage(self, x, cache_k, cache_v, anc, pos, age=None):
        """Lineage-kernel attention + this block's post-LN residual output."""
        q = self.wq(x)[:, 0, :]
        ctx = lineage_attention(q, cache_k, cache_v, anc, pos, self.num_heads, age=age)
        return self.out(ctx[:, None, :], x)


class BertFFNBlock(nn.Module):
    """HF BertIntermediate + BertOutput (exact gelu, post-LN residual)."""

    def __init__(self, hidden_size: int, intermediate_size: int, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(hidden_size, intermediate_size, dtype)
        self.BertSelfOutput_0 = BertSelfOutput(intermediate_size, hidden_size, dtype)

    def forward(self, x):
        h = F.gelu(self.Dense_0(x), approximate="none")
        return self.BertSelfOutput_0(h, x)


class BertLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.attention = BertAttentionBlock(hidden_size, num_heads, dtype)
        self.ffn = BertFFNBlock(hidden_size, intermediate_size, dtype)

    def forward(self, x, mask=None):
        return self.ffn(self.attention(x, x, mask=mask))


class BertCrossLayer(nn.Module):
    """Self-attn -> cross-attn -> FFN (reference BertCrossLayer)."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.attention = BertAttentionBlock(hidden_size, num_heads, dtype)
        self.crossattention = BertAttentionBlock(hidden_size, num_heads, dtype)
        self.ffn = BertFFNBlock(hidden_size, intermediate_size, dtype)

    def forward(self, x, enc, self_mask=None, cross_mask=None):
        x = self.attention(x, x, mask=self_mask)
        x = self.crossattention(x, enc, mask=cross_mask)
        return self.ffn(x)
