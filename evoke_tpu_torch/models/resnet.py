"""ResNet-101 visual extractor (port of evoke_tpu/models/resnet.py).

Public layout stays NHWC (images [B, H, W, 3]); inside, ``permute(0, 3, 1, 2)``
gives an NCHW view with channels-last strides, which cuDNN runs as NHWC
without a copy. Conv weights are OIHW in the compute dtype; BatchNorm keeps
float32 statistics (``train=True``: batch statistics, momentum 0.9, eps 1e-5).
``remat=True`` checkpoints each Bottleneck (``torch.utils.checkpoint``): the
backward pass recomputes a block's activations instead of keeping them, as
``nn.remat`` does in the JAX package; BatchNorm's running update stays
pending through the recomputation, so it lands once a step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from evoke_tpu_torch.models.layers import BatchNorm


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: input and kernel cast to ``dtype``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=dtype))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight, stride=self.stride,
                        padding=self.padding)


def _bn(c, dtype):
    return BatchNorm(c, eps=1e-5, dtype=dtype, axis=1)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1(x4), BN+ReLU, projection shortcut."""

    def __init__(self, cin: int, features: int, stride: int = 1, project: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(cin, features, 1, dtype=dtype)
        self.bn1 = _bn(features, dtype)
        self.conv2 = Conv(features, features, 3, stride, 1, dtype=dtype)
        self.bn2 = _bn(features, dtype)
        self.conv3 = Conv(features, features * 4, 1, dtype=dtype)
        self.bn3 = _bn(features * 4, dtype)
        self.project = project
        if project:
            self.downsample_conv = Conv(cin, features * 4, 1, stride, dtype=dtype)
            self.downsample_bn = _bn(features * 4, dtype)

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = (self.downsample_bn(self.downsample_conv(x), train) if self.project
                    else x)
        return F.relu(y + residual)


class ResNet101(nn.Module):
    """Backbone through C5. Input NCHW -> [B, 2048, H/32, W/32]."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 23, 3), dtype=torch.float32,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = Conv(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = _bn(64, dtype)
        self.blocks = []
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * (2 ** stage)
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blk = Bottleneck(cin, features, stride, project=(i == 0), dtype=dtype)
                self.add_module(f"layer{stage + 1}_{i}", blk)
                self.blocks.append(blk)
                cin = features * 4

    def forward(self, x, train: bool = False):
        x = F.relu(self.bn1(self.conv1(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, train, use_reentrant=False) if remat else blk(x, train)
        return x


class VisualExtractor(nn.Module):
    """ResNet-101 -> (patch_feats [B, N, 2048], avg_feats [B, 2048]); images NHWC."""

    def __init__(self, dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.backbone = ResNet101(dtype=dtype, remat=remat)

    def forward(self, images, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.backbone(images.permute(0, 3, 1, 2), train)     # [B, C, h, w]
        b, c, h, w = feats.shape
        patches = feats.permute(0, 2, 3, 1).reshape(b, h * w, c)
        return patches, patches.mean(dim=1)
