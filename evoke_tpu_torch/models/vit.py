"""ViT-B/32 visual encoder (port of evoke_tpu/models/vit.py).

Conv patchify (flax HWIO kernel, carried over as OIHW, with its bias), a CLS
token, learned positions sliced to the patch count + 1, pre-LN blocks (flax
LayerNorm, eps 1e-6; exact gelu), a final LayerNorm and a Dense lifting the
width to ``d_vf``. Returns (patch tokens [B, N, d_vf], CLS [B, d_vf]), the
ResNet extractor's surface; images NHWC.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.layers import Dense, LayerNorm, MultiHeadAttention, PositionwiseFFN


class ViTBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, mlp_dim: int, dropout_rate: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(width, dtype=dtype)
        self.MultiHeadAttention_0 = MultiHeadAttention(num_heads, width, dtype, dropout_rate)
        self.LayerNorm_1 = LayerNorm(width, dtype=dtype)
        self.PositionwiseFFN_0 = PositionwiseFFN(
            width, mlp_dim, dtype, dropout_rate,
            activation=lambda y: F.gelu(y, approximate="none"))

    def forward(self, x):
        h = self.LayerNorm_0(x)
        x = x + self.MultiHeadAttention_0(h, h, h)
        return x + self.PositionwiseFFN_0(self.LayerNorm_1(x))


class Patchify(nn.Module):
    """flax ``nn.Conv`` with a bias, stride = kernel, VALID: the product in
    ``dtype``, then the bias added in ``dtype``."""

    def __init__(self, width: int, patch: int, dtype=torch.float32):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(width, dtype=dtype))

    def forward(self, images):
        """images [B, H, W, 3] -> [B, h*w, width], patches in row-major order."""
        x = F.conv2d(images.permute(0, 3, 1, 2).to(self.dtype), self.weight, stride=self.patch)
        return x.flatten(2).transpose(1, 2) + self.bias


class ViTExtractor(nn.Module):
    """ViT-B/32 defaults; output width lifted to ``d_vf``."""

    def __init__(self, patch_size: int = 32, width: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, d_vf: int = 2048,
                 max_patches: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patchify = Patchify(width, patch_size, dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embed = nn.Parameter(torch.empty(1, max_patches + 1, width))
        self.blocks = []
        for i in range(num_layers):
            block = ViTBlock(width, num_heads, mlp_dim, dtype=dtype)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        self.final_ln = LayerNorm(width, dtype=dtype)
        self.proj = Dense(width, d_vf, dtype)

    def forward(self, images, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``train`` changes nothing (no dropout, no BatchNorm)."""
        x = self.patchify(images)
        b, n, _ = x.shape
        x = torch.cat([self.cls.to(self.dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embed[:, : n + 1].to(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.proj(self.final_ln(x))
        return x[:, 1:, :], x[:, 0, :]
