"""The PatchGAN discriminator of the GAN stages (PyTorch port).

Counterpart of the JAX package's ``models/vqgan.py:VQGANDiscriminator``
(reference vqgan_arch.py:425-468) on channels-last frames, with the
reference's ``main.{i}`` names.  Only this class of that file is ported
here; the rest of it (``VQAutoEncoder`` and its quantizers) is a secondary
architecture.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import KeepFloat32, conv_nhwc


class BatchNorm(KeepFloat32):
    """flax's ``nn.BatchNorm`` over [N, H, W, C] with torch's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``; no
    ``num_batches_tracked``).

    In train mode it normalizes with the batch's mean and *biased* variance
    (E[x^2] - mean^2, in fp32) and, unless `update_stats` is off, moves the
    running statistics by running = 0.9 * running + 0.1 * batch, also with
    the biased variance (``torch.nn.BatchNorm2d`` would store the unbiased
    one).  In eval mode it normalizes with the running statistics.  The
    affine and the statistics stay fp32; the output has x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 1, 2))
            var = ((xf * xf).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean * (1.0 - m))
                    self.running_var.mul_(m).add_(var * (1.0 - m))
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias
        return y.to(x.dtype)


class VQGANDiscriminator(nn.Module):
    """PatchGAN: a 4x4 stride-2 conv with LeakyReLU(0.2), `n_layers - 1`
    stride-2 conv + BN + LeakyReLU stages, a stride-1 one, then a stride-1
    conv to one logit per patch; padding 1 everywhere.

    forward(x [N, H, W, nc], train, update_stats) -> logits [N, h, w, 1].
    In train mode every BatchNorm uses the batch's statistics and (with
    `update_stats`) advances its running ones, so a training step that runs
    the discriminator several times threads them from pass to pass, as the
    JAX trainers thread `batch_stats`."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        layers = [nn.Conv2d(nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=2, padding=1, bias=False),
                       BatchNorm(ndf * mult), nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=1, padding=1, bias=False),
                   BatchNorm(ndf * mult), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1)]
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        for layer in self.main:
            if isinstance(layer, nn.Conv2d):
                x = conv_nhwc(layer, x)
            elif isinstance(layer, BatchNorm):
                x = layer(x, train=train, update_stats=update_stats)
            else:
                x = F.leaky_relu(x, 0.2)
        return x
