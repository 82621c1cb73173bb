"""Miscellaneous blocks of the reference's module zoo (PyTorch port).

Counterparts of the JAX package's ``nn/misc.py`` (reference
modules/rstt_layers.py:28-53, 116-132, 665-751, 915-937) on channels-last
tensors, with the JAX package's exported parameter names.  No deployed
model runs them; they are plain convs on every device.

Two layouts follow the weight bridge rather than torch's modules: the
transposed conv's ``deconv.weight`` is [out, in, kh, kw] (the flax kernel
[kh, kw, in, out] through the exporter's conv transpose), and flax's
``ConvTranspose`` does not flip its kernel, so output pixel (2i+a, 2j+b)
reads kernel tap (1-a, 1-b).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import ResnetBlock, conv_nhwc, layer_norm


def _frames(x: torch.Tensor):
    B, T, H, W, C = x.shape
    return x.reshape(B * T, H, W, C), (B, T)


class ResidualBlockNoBN(nn.Module):
    """x + conv(relu(conv(x))), 3x3 convs, no normalization."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv2 = nn.Conv2d(nf, nf, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x)))


class InputProj(nn.Module):
    """Per-frame conv + LeakyReLU(0.01) (+ LayerNorm): [B, T, H, W, C] ->
    [B, T, H', W', embed_dim]."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 32, kernel_size: int = 3,
                 stride: int = 1, use_norm: bool = False):
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, kernel_size, stride=stride,
                              padding=kernel_size // 2)
        self.norm = layer_norm(embed_dim) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, lead = _frames(x)
        h = F.leaky_relu(conv_nhwc(self.proj, h), 0.01)
        if self.norm is not None:
            h = self.norm(h)
        return h.reshape(*lead, *h.shape[1:])


class SResBlock(nn.Module):
    """`num_res_blocks` per-frame ResnetBlocks (``mid_{i}``) on
    [B, T, H, W, C]."""

    def __init__(self, in_channels: int, num_res_blocks: int,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        ch = in_channels
        for i in range(num_res_blocks):
            self.add_module(f"mid_{i}", ResnetBlock(ch, out_channels))
            ch = out_channels or ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, lead = _frames(x)
        for i in range(self.num_res_blocks):
            h = getattr(self, f"mid_{i}")(h)
        return h.reshape(*lead, *h.shape[1:])


class StridedDownsample(nn.Module):
    """4x4 stride-2 conv (padding 1) on [B, T, H, W, C]."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.conv = nn.Conv2d(in_chans, out_chans, 4, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, lead = _frames(x)
        h = conv_nhwc(self.conv, h)
        return h.reshape(*lead, *h.shape[1:])


class _TransposedConvParams(nn.Module):
    """A 2x2 stride-2 transposed conv's weight [out, in, 2, 2] (the
    exported layout) and bias."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_chans, in_chans, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_chans))

    def init_extra(self, g: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * 4
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=g) * fan_in ** -0.5)


class TransposedUpsample(nn.Module):
    """2x2 stride-2 transposed conv (flax ``ConvTranspose``, 'SAME') on
    [B, T, H, W, C] -> [B, T, 2H, 2W, out_chans]."""

    def __init__(self, in_chans: int, out_chans: int):
        super().__init__()
        self.deconv = _TransposedConvParams(in_chans, out_chans)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, lead = _frames(x)
        # torch's conv_transpose2d takes [in, out, kh, kw] and places tap
        # (a, b) at (2i+a, 2j+b); flax places it at (2i+1-a, 2j+1-b)
        w = self.deconv.weight.flip(2, 3).transpose(0, 1).to(h.dtype)
        y = F.conv_transpose2d(h.permute(0, 3, 1, 2), w, self.deconv.bias.to(h.dtype), stride=2)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(*lead, *y.shape[1:])
