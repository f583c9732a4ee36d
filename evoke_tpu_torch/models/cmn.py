"""Cross-modal Memory Network decoder (port of evoke_tpu/models/cmn.py).

A pre-LN transformer encoder-decoder plus a learnable memory matrix
[cmm_size, cmm_dim] queried through ``MultiThreadMemory`` (multi-head
attention that keeps only the top-k memory slots per query and head, ties to
the lowest index as ``lax.top_k``); the responses are added to the embedded
image tokens before encoding and to the embedded target tokens before
decoding. The scores and the gathered values are float32 whatever the
compute dtype (cmn.py:53-60). RMDecoder's surface; ``decode_step`` writes the
caches in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.causal_decoder import _decode_layers, _zero_caches
from evoke_tpu_torch.models.layers import (Dense, MultiHeadAttention, PositionwiseFFN,
                                           TokenEmbed, TorchLayerNorm, cached_self_attention,
                                           dropout, make_cross_mask, make_self_mask,
                                           sinusoidal_pe)
from evoke_tpu_torch.models.rm_decoder import EncoderLayer
from evoke_tpu_torch.ops.fused_logit_topk import topk_lowest_index


class MultiThreadMemory(nn.Module):
    """MHA over memory slots keeping only the top-k scores per query and head."""

    def __init__(self, num_heads: int, d_model: int, topk: int = 32,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.topk, self.dropout_rate, self.dtype = (num_heads, topk,
                                                                    dropout_rate, dtype)
        self.wq = Dense(d_model, d_model, dtype)
        self.wk = Dense(d_model, d_model, dtype)
        self.wv = Dense(d_model, d_model, dtype)
        self.wo = Dense(d_model, d_model, dtype)

    def forward(self, query, memory, rng=None):
        """query [B, T, D]; memory [M, D] -> responses [B, T, D]."""
        b, t, d = query.shape
        h = self.num_heads
        dk = d // h
        q = self.wq(query).reshape(b, t, h, dk).transpose(1, 2)           # [B, h, T, dk]
        k = self.wk(memory).reshape(-1, h, dk).transpose(0, 1)            # [h, M, dk]
        v = self.wv(memory).reshape(-1, h, dk).transpose(0, 1)            # [h, M, dk]
        scores = torch.einsum("bhtd,hmd->bhtm", q.float(), k.float()) / math.sqrt(dk)
        sel_scores, sel_idx = topk_lowest_index(scores, self.topk)        # [B, h, T, k]
        probs = dropout(torch.softmax(sel_scores, dim=-1), self.dropout_rate, rng)
        heads = torch.arange(h, device=query.device)[None, :, None, None]
        sel_v = v.float()[heads, sel_idx]                                 # [B, h, T, k, dk]
        out = torch.einsum("bhtk,bhtkd->bhtd", probs, sel_v)
        return self.wo(out.transpose(1, 2).reshape(b, t, d).to(self.dtype))


class PlainDecoderLayer(nn.Module):
    """Pre-LN decoder layer with a KV-cached step."""

    def __init__(self, d_model: int, d_ff: int, num_heads: int, dtype=torch.float32,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.src_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.ff = PositionwiseFFN(d_model, d_ff, dtype, dropout_rate)
        self.norm1 = TorchLayerNorm(d_model, dtype=dtype)
        self.norm2 = TorchLayerNorm(d_model, dtype=dtype)
        self.norm3 = TorchLayerNorm(d_model, dtype=dtype)

    def forward(self, x, enc, self_mask, cross_mask, rng=None):
        p = self.dropout_rate
        h = self.norm1(x)
        x = x + dropout(self.self_attn(h, h, h, mask=self_mask, rng=rng), p, rng)
        h = self.norm2(x)
        x = x + dropout(self.src_attn(h, enc, enc, mask=cross_mask, rng=rng), p, rng)
        return x + dropout(self.ff(self.norm3(x), rng), p, rng)

    def prepare_cross_kv(self, enc):
        return self.src_attn.project_kv(enc)

    def step(self, x, cross_k, cross_v, cross_mask, cache_k, cache_v, pos: int, anc=None):
        h = self.norm1(x)
        k_new, v_new = self.self_attn.project_kv(h)
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
        x = x + cached_self_attention(self.self_attn, h, cache_k, cache_v, pos, anc)
        h = self.norm2(x)
        x = x + self.src_attn.attend(h, cross_k, cross_v, mask=cross_mask)
        return x + self.ff(self.norm3(x)), cache_k, cache_v


class CMNDecoder(nn.Module):
    """BaseCMN's surface: memory-augmented encoder and decoder."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_ff: int = 512,
                 d_vf: int = 2048, num_layers: int = 3, num_heads: int = 8,
                 dropout_rate: float = 0.0, drop_prob_lm: float = 0.5, cmm_size: int = 2048,
                 cmm_dim: int = 512, topk: int = 32, max_seq_len: int = 100,
                 dtype=torch.float32):
        super().__init__()
        if cmm_dim != d_model:
            raise ValueError("CMN memory dim must equal d_model")
        self.d_model, self.num_layers, self.max_seq_len = d_model, num_layers, max_seq_len
        self.dtype, self.dropout_rate, self.drop_prob_lm = dtype, dropout_rate, drop_prob_lm
        self.att_embed = Dense(d_vf, d_model, dtype)
        self.cmn = MultiThreadMemory(num_heads, d_model, topk, dtype=dtype)
        self.memory_matrix = nn.Parameter(torch.empty(cmm_size, cmm_dim))
        self.enc_layers, self.dec_layers = [], []
        for i in range(num_layers):
            enc = EncoderLayer(d_model, d_ff, num_heads, dtype, dropout_rate)
            self.add_module(f"enc_{i}", enc)
            self.enc_layers.append(enc)
        self.enc_norm = TorchLayerNorm(d_model, dtype=dtype)
        for i in range(num_layers):
            dec = PlainDecoderLayer(d_model, d_ff, num_heads, dtype, dropout_rate)
            self.add_module(f"dec_{i}", dec)
            self.dec_layers.append(dec)
        self.dec_norm = TorchLayerNorm(d_model, dtype=dtype)
        self.tgt_embed = TokenEmbed(vocab_size + 1, d_model, dtype=dtype,
                                    dropout_rate=dropout_rate)
        self.register_buffer("pe", torch.tensor(sinusoidal_pe(5000, d_model)),
                             persistent=False)
        self.logit = Dense(d_model, vocab_size + 1, dtype)

    def encode(self, att_feats, att_mask, rng=None):
        """att_embed -> + memory responses -> + PE -> pre-LN encoder."""
        x = dropout(F.relu(self.att_embed(att_feats * att_mask[..., None])),
                    self.drop_prob_lm, rng)
        x = x + self.cmn(x, self.memory_matrix, rng)
        x = dropout(x + self.pe[None, : x.shape[1]], self.dropout_rate, rng)
        mask = make_cross_mask(att_mask)
        for layer in self.enc_layers:
            x = layer(x, mask=mask, rng=rng)
        return self.enc_norm(x)

    def forward(self, att_feats, att_mask, tgt_ids, tgt_mask, rng=None):
        enc = self.encode(att_feats, att_mask, rng)
        return self.decode_train(enc, att_mask, tgt_ids, tgt_mask, rng)

    def decode_train(self, enc, att_mask, tgt_ids, tgt_mask, rng=None):
        x = self.tgt_embed(tgt_ids, rng)
        x = x + self.cmn(x, self.memory_matrix, rng)
        self_mask = make_self_mask(tgt_mask, causal=True)
        cross_mask = make_cross_mask(att_mask)
        for layer in self.dec_layers:
            x = layer(x, enc, self_mask, cross_mask, rng)
        return torch.log_softmax(self.logit(self.dec_norm(x)), dim=-1, dtype=torch.float32)

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None
                          ) -> Dict[str, Any]:
        lmax = max_len or self.max_seq_len
        cross = [layer.prepare_cross_kv(enc) for layer in self.dec_layers]
        zeros = lambda: _zero_caches(batch, lmax, self.dec_layers[0].self_attn.kv_width,  # noqa: E731
                                     self.num_layers, self.dtype, enc.device)
        return {"cache_k": zeros(), "cache_v": zeros(),
                "cross_k": tuple(c[0] for c in cross), "cross_v": tuple(c[1] for c in cross)}

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False):
        x = self.tgt_embed.at_position(tok, pos)
        x = x + self.cmn(x, self.memory_matrix)
        return _decode_layers(self.dec_layers, x, pos, state, att_mask, self.dec_norm,
                              self.logit, return_logits)
