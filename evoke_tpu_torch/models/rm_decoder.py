"""R2Gen-style report decoder (port of evoke_tpu/models/rm_decoder.py).

Relational memory + conditional LayerNorm, with KV-cached incremental decoding.
Dtypes follow the JAX package, which rounds at these places (bf16 compute):

- the token embedding is bf16 but the PE table is float32, so the decoder's
  residual stream is float32;
- ``RelationalMemory`` and its MHA carry no compute dtype and run float32;
- the CLN gamma/beta MLPs stay float32 on purpose (rm_decoder.py:101-110) and
  a CLN returns its input's dtype (float32 here);
- every other Dense rounds to bf16; caches are bf16; ``dec_norm`` returns bf16
  and so do the logits.

Unlike JAX, ``decode_step`` writes the new K/V into the caches IN PLACE (the
returned state holds the same cache tensors): a decode state is used once.
The training forward (``decode_train``) and the int8 cache are ROADMAP A10/A12a.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.layers import (Dense, MultiHeadAttention, PositionwiseFFN,
                                           TokenEmbed, TorchLayerNorm,
                                           cached_self_attention, make_cross_mask)
from evoke_tpu_torch.ops.fused_logit_topk import fused_logit_topk


class RelationalMemory(nn.Module):
    """Gated slot memory rolled over target embeddings (float32)."""

    def __init__(self, num_slots: int, d_model: int, num_heads: int = 8):
        super().__init__()
        self.num_slots, self.d_model = num_slots, d_model
        self.attn = MultiHeadAttention(num_heads, d_model, dtype=torch.float32)
        self.mlp1 = Dense(d_model, d_model)
        self.mlp2 = Dense(d_model, d_model)
        self.W = Dense(d_model, 2 * d_model)
        self.U = Dense(d_model, 2 * d_model)

    def init_memory(self, batch_size: int, device=None) -> torch.Tensor:
        """[B, S*D]: identity over slots, zero-padded to d_model."""
        s, d = self.num_slots, self.d_model
        eye = torch.eye(s, device=device)
        mem = (torch.cat([eye, torch.zeros(s, d - s, device=device)], dim=-1)
               if d > s else eye[:, :d])
        return mem.reshape(1, s * d).repeat(batch_size, 1)

    def step(self, x_t, memory):
        """x_t [B, D], memory [B, S*D] -> next [B, S*D]."""
        b = x_t.shape[0]
        s, d = self.num_slots, self.d_model
        mem = memory.reshape(b, s, d)
        kv = torch.cat([mem, x_t[:, None, :]], dim=1)
        nxt = mem + self.attn(mem, kv, kv)
        nxt = nxt + F.relu(self.mlp2(F.relu(self.mlp1(nxt))))
        gates = self.W(x_t[:, None, :]) + self.U(torch.tanh(mem))
        input_gate, forget_gate = gates.split(d, dim=-1)
        nxt = torch.sigmoid(input_gate) * torch.tanh(nxt) + torch.sigmoid(forget_gate) * mem
        return nxt.reshape(b, s * d)


class ConditionalLayerNorm(nn.Module):
    """LN whose scale/shift are offset by float32 MLPs of the memory."""

    def __init__(self, d_model: int, mem_dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(d_model))
        self.beta = nn.Parameter(torch.zeros(d_model))
        self.mlp_gamma_0 = Dense(mem_dim, d_model, torch.float32)
        self.mlp_gamma_1 = Dense(d_model, d_model, torch.float32)
        self.mlp_beta_0 = Dense(mem_dim, d_model, torch.float32)
        self.mlp_beta_1 = Dense(d_model, d_model, torch.float32)

    def forward(self, x, memory):
        d = x.shape[-1]
        m = memory.float()
        dg = self.mlp_gamma_1(F.relu(self.mlp_gamma_0(m)))
        db = self.mlp_beta_1(F.relu(self.mlp_beta_0(m)))
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf - mean) ** 2).sum(-1, keepdim=True) / max(d - 1, 1)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return ((self.gamma + dg) * y + (self.beta + db)).to(x.dtype)


class EncoderLayer(nn.Module):
    """Pre-LN self-attention + FFN."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.ff = PositionwiseFFN(d_model, d_ff, dtype)
        self.norm1 = TorchLayerNorm(d_model, dtype=dtype)
        self.norm2 = TorchLayerNorm(d_model, dtype=dtype)

    def forward(self, x, mask=None):
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, mask=mask)
        return x + self.ff(self.norm2(x))


class RMDecoderLayer(nn.Module):
    """Decoder layer with conditional-LN sublayers; decode-step form only."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, mem_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype)
        self.ff = PositionwiseFFN(d_model, d_ff, dtype)
        self.cln1 = ConditionalLayerNorm(d_model, mem_dim)
        self.cln2 = ConditionalLayerNorm(d_model, mem_dim)
        self.cln3 = ConditionalLayerNorm(d_model, mem_dim)

    def prepare_cross_kv(self, enc):
        return self.src_attn.project_kv(enc)

    def step(self, x, cross_k, cross_v, cross_mask, memory, cache_k, cache_v, pos: int,
             anc=None, age=None):
        """x [N, 1, D]; memory [N, 1, S*D]; caches [N, L, D] written at ``pos``
        in place; anc optional [B, k, L]; age optional [N] ring ages."""
        h = self.cln1(x, memory)
        k_new, v_new = self.self_attn.project_kv(h)
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
        x = x + cached_self_attention(self.self_attn, h, cache_k, cache_v, pos, anc, age=age)
        h = self.cln2(x, memory)
        x = x + self.src_attn.attend(h, cross_k, cross_v, mask=cross_mask)
        h = self.cln3(x, memory)
        return x + self.ff(h), cache_k, cache_v


class RMDecoder(nn.Module):
    """Image-token encoder + relational-memory decoder (inference surface)."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_ff: int = 512,
                 d_vf: int = 2048, num_layers: int = 3, num_heads: int = 8,
                 rm_num_slots: int = 3, rm_num_heads: int = 8, rm_d_model: int = 512,
                 max_seq_len: int = 100, dtype=torch.float32):
        super().__init__()
        if rm_d_model != d_model:
            raise ValueError("rm_d_model must equal d_model")
        self.vocab_size, self.d_model = vocab_size, d_model
        self.num_layers, self.max_seq_len, self.dtype = num_layers, max_seq_len, dtype
        self.att_embed = Dense(d_vf, d_model, dtype)
        self.enc_layers, self.dec_layers = [], []
        for i in range(num_layers):
            enc = EncoderLayer(d_model, d_ff, num_heads, dtype)
            self.add_module(f"enc_{i}", enc)
            self.enc_layers.append(enc)
        self.enc_norm = TorchLayerNorm(d_model, dtype=dtype)
        for i in range(num_layers):
            dec = RMDecoderLayer(d_model, d_ff, num_heads, rm_num_slots * rm_d_model, dtype)
            self.add_module(f"dec_{i}", dec)
            self.dec_layers.append(dec)
        self.dec_norm = TorchLayerNorm(d_model, dtype=dtype)
        self.tgt_embed = TokenEmbed(vocab_size + 1, d_model, dtype=dtype)
        self.rm = RelationalMemory(rm_num_slots, rm_d_model, rm_num_heads)
        self.logit = Dense(d_model, vocab_size + 1, dtype)

    def encode(self, att_feats, att_mask):
        """att_feats [B, P, d_vf], att_mask [B, P] -> [B, P, d_model]."""
        x = F.relu(self.att_embed(att_feats * att_mask[..., None]))
        mask = make_cross_mask(att_mask)
        for layer in self.enc_layers:
            x = layer(x, mask=mask)
        return self.enc_norm(x)

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None
                          ) -> Dict[str, Any]:
        """Decode carry: relational memory, per-layer self-attn KV caches
        [batch, L, D] and beam-invariant cross K/V (one row per sample)."""
        lmax = max_len or self.max_seq_len
        cross = [layer.prepare_cross_kv(enc) for layer in self.dec_layers]

        def zeros():
            return torch.zeros(batch, lmax, self.d_model, dtype=self.dtype, device=enc.device)

        return {
            "memory": self.rm.init_memory(batch, enc.device),
            "cache_k": tuple(zeros() for _ in range(self.num_layers)),
            "cache_v": tuple(zeros() for _ in range(self.num_layers)),
            "cross_k": tuple(c[0] for c in cross),
            "cross_v": tuple(c[1] for c in cross),
        }

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False,
                    age=None, return_topk: Optional[int] = None, topk_suppress=()):
        """tok [N], pos: step -> (log-probs [N, V+1], new state).

        ``return_logits``: the first element is the raw logits instead.
        ``return_topk=k``: the vocab tail runs as the fused logit + top-k
        kernel (ops/fused_logit_topk.py) and the first element is
        (vals [N, k] f32, idx [N, k] i32, lse [N] f32), ``topk_suppress`` ids
        knocked down by -1000 inside it."""
        x = self.tgt_embed.at_position(tok, pos, age=age)          # [N, 1, D]
        mem = self.rm.step(x[:, 0, :], state["memory"])            # [N, S*D]
        cross_mask = make_cross_mask(att_mask)
        anc = state.get("anc")
        new_k, new_v = [], []
        for i, layer in enumerate(self.dec_layers):
            x, ck, cv = layer.step(x, state["cross_k"][i], state["cross_v"][i], cross_mask,
                                   mem[:, None, :], state["cache_k"][i],
                                   state["cache_v"][i], pos, anc=anc, age=age)
            new_k.append(ck)
            new_v.append(cv)
        x = self.dec_norm(x)
        if return_topk:
            out = fused_logit_topk(x[:, 0, :].to(self.dtype).contiguous(),
                                   self.logit.weight, self.logit.bias,
                                   int(return_topk), tuple(topk_suppress))
        else:
            logits = self.logit(x)[:, 0, :]
            out = logits if return_logits else torch.log_softmax(logits.float(), dim=-1)
        new_state = dict(state, memory=mem, cache_k=tuple(new_k), cache_v=tuple(new_v))
        return out, new_state
