"""Projection heads (port of evoke_tpu/models/heads.py).

``train=True``: the BatchNorms use batch statistics over (batch, token).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from evoke_tpu_torch.models.layers import BatchNorm, Dense


class SeqBatchNorm(nn.Module):
    """BatchNorm over (batch, token) per channel on [B, T, C] (channels last)."""

    def __init__(self, features: int, use_affine: bool = True, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(features, eps=eps, affine=use_affine, dtype=dtype)

    def forward(self, x, train: bool = False):
        return self.BatchNorm_0(x, train)


class ProjectionHead(nn.Module):
    """Dense -> BN -> ReLU -> Dense [-> affine-free BN]."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 final_bn: bool = False, dtype=torch.float32):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_dim, dtype)
        self.SeqBatchNorm_0 = SeqBatchNorm(hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(hidden_dim, output_dim, dtype)
        self.final_bn = final_bn
        if final_bn:
            self.SeqBatchNorm_1 = SeqBatchNorm(output_dim, use_affine=False, dtype=dtype)

    def forward(self, x, train: bool = False):
        """x: [B, T, C_in] -> [B, T, output_dim]; also [B, C_in]."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        x = F.relu(self.SeqBatchNorm_0(self.Dense_0(x), train))
        x = self.Dense_1(x)
        if self.final_bn:
            x = self.SeqBatchNorm_1(x, train)
        return x[:, 0] if squeeze else x
