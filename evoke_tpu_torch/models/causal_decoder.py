"""Causal-LM text decoders with cross-attention (port of
evoke_tpu/models/causal_decoder.py).

- ``CausalDecoder`` (``decoder_kind="causal"``): pre-LN layers (flax
  LayerNorm, eps 1e-6), learned positions, gelu (exact for ``style="bert"``,
  tanh for ``"gpt2"``), a final LayerNorm.
- ``BertGenerationDecoder`` (``decoder_kind="bertgen"``): HF
  BertGeneration's post-LN ``BertCrossLayer`` stack over word + position
  embeddings with their LayerNorm (eps 1e-12), the LM head straight on the
  last layer.

Both have RMDecoder's surface: ``forward`` (teacher-forced float32
log-probs), ``encode`` (the image tokens projected to the decoder width; no
encoder stack), ``init_decode_state`` and ``decode_step``, which writes the
new K/V into the caches in place. In ancestor mode the self-attention reads
its caches through the lineage kernel (``layers.cached_self_attention``).
Dropout draws from the generator ``rng``; ``rng=None`` is deterministic.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.layers import (BertCrossLayer, Dense, Embed, LayerNorm,
                                           MultiHeadAttention, PositionwiseFFN,
                                           cached_self_attention, dropout, make_cross_mask,
                                           make_self_mask)


def _zero_caches(batch: int, lmax: int, d: int, layers: int, dtype, device):
    return tuple(torch.zeros(batch, lmax, d, dtype=dtype, device=device)
                 for _ in range(layers))


def _project_image_tokens(att_embed, att_feats, att_mask, rate: float, rng):
    """relu(att_embed(att_feats * mask)) with dropout ``rate``."""
    return dropout(F.relu(att_embed(att_feats * att_mask[..., None])), rate, rng)


class CausalLayer(nn.Module):
    """Pre-LN causal layer: self-attn -> cross-attn -> FFN, with a KV-cached step."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dropout_rate: float = 0.1,
                 gelu_approximate: bool = False, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(d_model, dtype=dtype)
        self.ln2 = LayerNorm(d_model, dtype=dtype)
        self.ln3 = LayerNorm(d_model, dtype=dtype)
        self.self_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        self.cross_attn = MultiHeadAttention(num_heads, d_model, dtype, dropout_rate)
        approx = "tanh" if gelu_approximate else "none"
        self.ff = PositionwiseFFN(d_model, d_ff, dtype, dropout_rate,
                                  activation=lambda y: F.gelu(y, approximate=approx))

    def forward(self, x, enc, self_mask, cross_mask, rng=None):
        h = self.ln1(x)
        x = x + self.self_attn(h, h, h, mask=self_mask, rng=rng)
        h = self.ln2(x)
        x = x + self.cross_attn(h, enc, enc, mask=cross_mask, rng=rng)
        return x + self.ff(self.ln3(x), rng)

    def prepare_cross_kv(self, enc):
        return self.cross_attn.project_kv(enc)

    def step(self, x, cross_k, cross_v, cross_mask, cache_k, cache_v, pos: int, anc=None):
        h = self.ln1(x)
        k_new, v_new = self.self_attn.project_kv(h)
        cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)
        x = x + cached_self_attention(self.self_attn, h, cache_k, cache_v, pos, anc)
        h = self.ln2(x)
        x = x + self.cross_attn.attend(h, cross_k, cross_v, mask=cross_mask)
        return x + self.ff(self.ln3(x)), cache_k, cache_v


class CausalDecoder(nn.Module):
    """RMDecoder's surface over pre-LN causal layers and learned positions."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_ff: int = 2048,
                 d_vf: int = 2048, num_layers: int = 3, num_heads: int = 8,
                 dropout_rate: float = 0.1, drop_prob_lm: float = 0.5,
                 max_seq_len: int = 100, max_positions: int = 512, style: str = "bert",
                 dtype=torch.float32):
        super().__init__()
        self.d_model, self.num_layers, self.max_seq_len = d_model, num_layers, max_seq_len
        self.dtype, self.dropout_rate, self.drop_prob_lm = dtype, dropout_rate, drop_prob_lm
        self.att_embed = Dense(d_vf, d_model, dtype)
        self.tok_embed = Embed(vocab_size + 1, d_model, dtype)
        self.pos_embed = Embed(max_positions, d_model, dtype)
        self.layers = []
        for i in range(num_layers):
            layer = CausalLayer(d_model, num_heads, d_ff, dropout_rate,
                                gelu_approximate=style == "gpt2", dtype=dtype)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.final_ln = LayerNorm(d_model, dtype=dtype)
        self.logit = Dense(d_model, vocab_size + 1, dtype)

    def encode(self, att_feats, att_mask, rng=None):
        return _project_image_tokens(self.att_embed, att_feats, att_mask, self.drop_prob_lm,
                                     rng)

    def forward(self, att_feats, att_mask, tgt_ids, tgt_mask, rng=None):
        enc = self.encode(att_feats, att_mask, rng)
        return self.decode_train(enc, att_mask, tgt_ids, tgt_mask, rng)

    def decode_train(self, enc, att_mask, tgt_ids, tgt_mask, rng=None):
        t = tgt_ids.shape[1]
        x = self.tok_embed(tgt_ids) + self.pos_embed(torch.arange(t, device=tgt_ids.device))[None]
        x = dropout(x, self.dropout_rate, rng)
        self_mask = make_self_mask(tgt_mask, causal=True)
        cross_mask = make_cross_mask(att_mask)
        for layer in self.layers:
            x = layer(x, enc, self_mask, cross_mask, rng)
        return torch.log_softmax(self.logit(self.final_ln(x)), dim=-1, dtype=torch.float32)

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None
                          ) -> Dict[str, Any]:
        lmax = max_len or self.max_seq_len
        cross = [layer.prepare_cross_kv(enc) for layer in self.layers]
        zeros = lambda: _zero_caches(batch, lmax, self.layers[0].self_attn.kv_width,  # noqa: E731
                                     self.num_layers, self.dtype, enc.device)
        return {"cache_k": zeros(), "cache_v": zeros(),
                "cross_k": tuple(c[0] for c in cross), "cross_v": tuple(c[1] for c in cross)}

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False):
        x = self.tok_embed(tok)[:, None, :] + self.pos_embed.weight[pos][None, None, :]
        return _decode_layers(self.layers, x, pos, state, att_mask, self.final_ln, self.logit,
                              return_logits)


def _decode_layers(layers, x, pos: int, state, att_mask, norm, head, return_logits: bool):
    """The zoo decoders' decode step after the embedding: every layer's step
    (caches written in place), ``norm`` (or none), the logit head; ->
    (log-probs or raw logits [N, V+1], new state)."""
    cross_mask = make_cross_mask(att_mask)
    anc = state.get("anc")
    for i, layer in enumerate(layers):
        x, _, _ = layer.step(x, state["cross_k"][i], state["cross_v"][i], cross_mask,
                             state["cache_k"][i], state["cache_v"][i], pos, anc=anc)
    if norm is not None:
        x = norm(x)
    logits = head(x)[:, 0, :]
    return (logits if return_logits else torch.log_softmax(logits.float(), dim=-1)), state


class BertGenerationEmbeddings(nn.Module):
    """HF BertGenerationEmbeddings: word + position, LayerNorm (eps 1e-12),
    dropout; no token types."""

    def __init__(self, vocab_size: int, hidden_size: int, max_positions: int = 512,
                 dropout_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.word_embeddings = Embed(vocab_size, hidden_size, dtype)
        self.position_embeddings = Embed(max_positions, hidden_size, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)

    def forward(self, ids, rng=None):
        t = ids.shape[1]
        x = self.word_embeddings(ids) + self.position_embeddings(
            torch.arange(t, device=ids.device))[None]
        return dropout(self.LayerNorm_0(x), self.dropout_rate, rng)

    def at_position(self, ids, pos: int):
        """ids [N] -> [N, 1, H] at decode position ``pos``."""
        x = self.word_embeddings(ids)[:, None, :] + self.position_embeddings.weight[pos][
            None, None, :]
        return self.LayerNorm_0(x)


class BertGenerationDecoder(nn.Module):
    """BertGeneration causal LM with cross-attention: post-LN
    ``BertCrossLayer``s (exact gelu), learned positions, the LM head without
    a transform; RMDecoder's surface."""

    def __init__(self, vocab_size: int, d_model: int = 512, d_ff: int = 2048,
                 d_vf: int = 2048, num_layers: int = 3, num_heads: int = 8,
                 dropout_rate: float = 0.1, drop_prob_lm: float = 0.5,
                 max_seq_len: int = 100, max_positions: int = 512, dtype=torch.float32):
        super().__init__()
        self.d_model, self.num_layers, self.max_seq_len = d_model, num_layers, max_seq_len
        self.dtype, self.drop_prob_lm = dtype, drop_prob_lm
        self.att_embed = Dense(d_vf, d_model, dtype)
        self.embeddings = BertGenerationEmbeddings(vocab_size + 1, d_model, max_positions,
                                                   dropout_rate, dtype)
        self.layers = []
        for i in range(num_layers):
            layer = BertCrossLayer(d_model, num_heads, d_ff, dtype, dropout_rate)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.lm_head = Dense(d_model, vocab_size + 1, dtype)

    def encode(self, att_feats, att_mask, rng=None):
        return _project_image_tokens(self.att_embed, att_feats, att_mask, self.drop_prob_lm,
                                     rng)

    def forward(self, att_feats, att_mask, tgt_ids, tgt_mask, rng=None):
        enc = self.encode(att_feats, att_mask, rng)
        return self.decode_train(enc, att_mask, tgt_ids, tgt_mask, rng)

    def decode_train(self, enc, att_mask, tgt_ids, tgt_mask, rng=None):
        x = self.embeddings(tgt_ids, rng)
        self_mask = make_self_mask(tgt_mask, causal=True)
        cross_mask = make_cross_mask(att_mask)
        for layer in self.layers:
            x = layer(x, enc, self_mask=self_mask, cross_mask=cross_mask, rng=rng)
        return torch.log_softmax(self.lm_head(x), dim=-1, dtype=torch.float32)

    def init_decode_state(self, enc, batch: int, max_len: Optional[int] = None
                          ) -> Dict[str, Any]:
        lmax = max_len or self.max_seq_len
        cross = [layer.prepare_cross_kv(enc) for layer in self.layers]
        zeros = lambda: _zero_caches(batch, lmax, self.layers[0].attention.kv_width,  # noqa: E731
                                     self.num_layers, self.dtype, enc.device)
        return {"cache_k": zeros(), "cache_v": zeros(),
                "cross_k": tuple(c[0] for c in cross), "cross_v": tuple(c[1] for c in cross)}

    def decode_step(self, tok, pos: int, state, att_mask, return_logits: bool = False):
        x = self.embeddings.at_position(tok, pos)
        return _decode_layers(self.layers, x, pos, state, att_mask, None, self.lm_head,
                              return_logits)
