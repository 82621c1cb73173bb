"""Image-space ops on channels-last tensors: normalization, AdaIN, resizes.

Every function takes and returns ``[..., H, W, C]`` tensors, the layout of
the JAX package's public functions.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """Normalize [..., C=3] images in [0,1] with ImageNet statistics, in
    fp32 whatever x's dtype (the caller rounds the result once)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.float() - mean) / std


def adaptive_instance_normalization(content: torch.Tensor,
                                    style: torch.Tensor,
                                    eps: float = 1e-5) -> torch.Tensor:
    """AdaIN on [B, H, W, C]: per-sample, per-channel spatial mean and
    unbiased std (reference codeformer_arch.py:15-46)."""
    B, H, W, C = content.shape

    def stats(f):
        flat = f.reshape(B, H * W, C)
        mean = flat.mean(dim=1, keepdim=True)
        var = flat.var(dim=1, keepdim=True, unbiased=True) + eps
        return mean.reshape(B, 1, 1, C), var.sqrt().reshape(B, 1, 1, C)

    c_mean, c_std = stats(content)
    s_mean, s_std = stats(style)
    return (content - c_mean) / c_std * s_std + s_mean


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)


def _back(y: torch.Tensor, lead) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], y.shape[1])


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """`F.interpolate(mode='nearest')` (floor indexing) on [..., H, W, C]."""
    if tuple(out_hw) == tuple(x.shape[-3:-1]):
        return x
    y = F.interpolate(_nchw(x), size=tuple(out_hw), mode="nearest")
    return _back(y, x.shape[:-3])


def resize_bilinear_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """`F.interpolate(mode='bilinear', align_corners=True)` on [..., H, W, C]."""
    if tuple(out_hw) == tuple(x.shape[-3:-1]):
        return x
    y = F.interpolate(_nchw(x), size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return _back(y, x.shape[:-3])


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., 1, 1, C]."""
    return x.mean(dim=(-3, -2), keepdim=True)
