"""BiSeNet face-parsing network (the "condition network"), PyTorch port.

A 19-class BiSeNet on a ResNet-18 trunk whose three heads are concatenated
into the 57-channel prior at the latent resolution (reference
pgtformer_arch.py:34-397).  The parser is frozen in every stage of the
deployed recipe, so BatchNorm always uses its running statistics.
I/O: ImageNet-normalized [N, H, W, 3] -> [N, *out_hw, 3*n_classes].
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import conv_nhwc
from pgtformer_tpu_torch.ops.image import (
    global_avg_pool, resize_bilinear_align_corners, resize_nearest)


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d on running statistics (eps 1e-5) over [N, H, W, C], with
    torch's parameter names and no `num_batches_tracked` buffer."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_extra(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * a + (self.bias - self.running_mean * a)


def _conv(cin, cout, ks, stride=1, padding=0):
    return nn.Conv2d(cin, cout, ks, stride=stride, padding=padding, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin: int, cout: int, ks: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, ks, stride, padding)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(conv_nhwc(self.conv, x)))


class BasicBlock(nn.Module):
    """ResNet-18 basic block."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(cout)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            FrozenBatchNorm(cout))

    def forward(self, x):
        r = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        r = self.bn2(conv_nhwc(self.conv2, r))
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample[1](conv_nhwc(self.downsample[0], x))
        return F.relu(shortcut + r)


class Resnet18(nn.Module):
    """Stride-32 ResNet-18 trunk returning the 1/8, 1/16, 1/32 features."""

    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)

        def layer(cin, cout, stride):
            return nn.Sequential(BasicBlock(cin, cout, stride), BasicBlock(cout, cout, 1))

        self.layer1 = layer(64, 64, 1)
        self.layer2 = layer(64, 128, 2)
        self.layer3 = layer(128, 256, 2)
        self.layer4 = layer(256, 512, 2)

    def forward(self, x):
        x = F.relu(self.bn1(conv_nhwc(self.conv1, x)))
        # MaxPool2d(3, 2, 1) pads with -inf
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        x = self.layer1(x)
        feat8 = self.layer2(x)
        feat16 = self.layer3(feat8)
        feat32 = self.layer4(feat16)
        return feat8, feat16, feat32


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = _conv(cout, cout, 1)
        self.bn_atten = FrozenBatchNorm(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = self.bn_atten(conv_nhwc(self.conv_atten, global_avg_pool(feat)))
        return feat * torch.sigmoid(atten)


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        hw8, hw16, hw32 = feat8.shape[1:3], feat16.shape[1:3], feat32.shape[1:3]
        avg_up = resize_nearest(self.conv_avg(global_avg_pool(feat32)), hw32)
        feat32_up = self.conv_head32(resize_nearest(self.arm32(feat32) + avg_up, hw16))
        feat16_up = self.conv_head16(resize_nearest(self.arm16(feat16) + feat32_up, hw8))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv1 = _conv(cout, cout // 4, 1)
        self.conv2 = _conv(cout // 4, cout, 1)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], dim=-1))
        atten = F.relu(conv_nhwc(self.conv1, global_avg_pool(feat)))
        atten = torch.sigmoid(conv_nhwc(self.conv2, atten))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    def __init__(self, cin: int, mid: int, n_classes: int):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = _conv(mid, n_classes, 1)

    def forward(self, x):
        return conv_nhwc(self.conv_out, self.conv(x))


class BiSeNet(nn.Module):
    """Face parser emitting the 3*n_classes-channel prior at `out_hw`."""

    def __init__(self, n_classes: int = 19, out_hw=(32, 32)):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat_res8, feat_cp8, feat_cp16 = self.cp(x)
        feat_fuse = self.ffm(feat_res8, feat_cp8)
        outs = [self.conv_out(feat_fuse), self.conv_out16(feat_cp8),
                self.conv_out32(feat_cp16)]
        return torch.cat([resize_bilinear_align_corners(o, self.out_hw) for o in outs],
                         dim=-1)
