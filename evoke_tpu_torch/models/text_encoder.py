"""BERT-style text encoder (port of evoke_tpu/models/text_encoder.py)."""

from __future__ import annotations

import torch
import torch.nn as nn

from evoke_tpu_torch.models.layers import BertLayer, Embed, LayerNorm, dropout, make_self_mask


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, max_positions: int = 512,
                 type_vocab_size: int = 2, dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.word_embeddings = Embed(vocab_size, hidden_size, dtype)
        self.position_embeddings = Embed(max_positions, hidden_size, dtype)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_size, dtype)
        self.LayerNorm_0 = LayerNorm(hidden_size, eps=1e-12, dtype=dtype)

    def forward(self, ids, rng=None):
        b, t = ids.shape
        pos = torch.arange(t, device=ids.device)[None].expand(b, t)
        x = (self.word_embeddings(ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(torch.zeros_like(ids)))
        return dropout(self.LayerNorm_0(x), self.dropout_rate, rng)


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int = 768, num_layers: int = 6,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_positions: int = 512, dtype=torch.float32, dropout_rate: float = 0.1):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden_size, max_positions, dtype=dtype,
                                         dropout_rate=dropout_rate)
        self.layers = []
        for i in range(num_layers):
            layer = BertLayer(hidden_size, num_heads, intermediate_size, dtype, dropout_rate)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)

    def forward(self, input_ids, attention_mask, rng=None):
        """input_ids [B, T], attention_mask [B, T] (1 = token) -> [B, T, H];
        ``rng``: dropout generator (embedding and layer dropout)."""
        x = self.embeddings(input_ids, rng)
        mask = make_self_mask(attention_mask)
        for layer in self.layers:
            x = layer(x, mask=mask, rng=rng)
        return x
