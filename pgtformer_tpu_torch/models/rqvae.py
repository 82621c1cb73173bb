"""RQVAE, the frame-wise (2-D) residual-quantized VQGAN (PyTorch port).

Counterpart of the JAX package's ``models/rqvae.py`` (reference
archs/rqvae_arch.py:579-931): the tower layout of ``TDCRQVAE3`` with
per-image ResnetBlocks and dense single-head :class:`AttnBlock2D`s in place
of the spatio-temporal window attention, and the port's
:class:`RQBottleneck` (kernel K5 on a CUDA tensor, once per quantizer depth
per forward).  Module names are the reference's (``down.{i}.block.{j}``,
``down.{i}.attn.{j}``, ``mid.block_1``, ``up.{i}.upsample``, ...).
``ddconfig.dropout`` is not applied: in JAX it is a dropout layer that no
caller takes out of its deterministic mode, so an identity there too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from pgtformer_tpu_torch.config import DDConfig, VQVAEConfig
from pgtformer_tpu_torch.models.quantizer import RQBottleneck
from pgtformer_tpu_torch.models.vqgan import AttnBlock2D
from pgtformer_tpu_torch.nn.blocks import (
    Downsample, GroupNorm, ResnetBlock, Upsample, conv_nhwc, init_weights)
from pgtformer_tpu_torch.registry import ARCH_REGISTRY


class _Mid(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.block_1 = ResnetBlock(dim)
        self.attn_1 = AttnBlock2D(dim)
        self.block_2 = ResnetBlock(dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h)))


def _level() -> nn.Module:
    """A tower level: ``block`` and ``attn`` lists (an upsample or
    downsample is added by the tower)."""
    level = nn.Module()
    level.block = nn.ModuleList()
    level.attn = nn.ModuleList()
    return level


class Encoder2D(nn.Module):
    """[N, H, W, C_in] -> [N, H/2^L, W/2^L, z_channels]."""

    def __init__(self, cfg: DDConfig):
        super().__init__()
        self.cfg = cfg
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i, res in enumerate(cfg.level_resolutions()):
            block_out = cfg.ch * cfg.ch_mult[i]
            level = _level()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock2D(block_in))
            if i != cfg.num_resolutions - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv)
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm(block_in)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, out_c, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv_nhwc(self.conv_in, x)
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != self.cfg.num_resolutions - 1:
                h = level.downsample(h)
        return conv_nhwc(self.conv_out, self.norm_out(self.mid(h), silu=True))


class Decoder2D(nn.Module):
    """z [N, h, w, z_channels] -> [N, H, W, out_ch]."""

    def __init__(self, cfg: DDConfig):
        super().__init__()
        self.cfg = cfg
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = {}
        for i in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[i]
            level = _level()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock2D(block_in))
            if i != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv)
                curr_res *= 2
            levels[i] = level
        self.up = nn.ModuleList([levels[i] for i in range(cfg.num_resolutions)])
        self.norm_out = GroupNorm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(conv_nhwc(self.conv_in, z))
        for i in reversed(range(self.cfg.num_resolutions)):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            if i != 0:
                h = level.upsample(h)
        return conv_nhwc(self.conv_out, self.norm_out(h, silu=True))


class _RQAutoEncoder(nn.Module):
    """The 2-D towers, the bottleneck and the 1x1 convs around it, shared
    by :class:`RQVAE` and ``TDRQVAE``."""

    def __init__(self, cfg: VQVAEConfig, group=None):
        super().__init__()
        if cfg.loss_type not in ("mse", "l1"):
            raise ValueError(f"loss_type {cfg.loss_type!r} (choices: mse, l1)")
        self.cfg = cfg
        dd = cfg.ddconfig
        self.encoder = Encoder2D(dd)
        self.decoder = Decoder2D(dd)
        self.quantizer = RQBottleneck(cfg.latent_shape, cfg.code_shape, cfg.n_embed, cfg.decay,
                                      cfg.shared_codebook, cfg.restart_unused_codes, group=group)
        self.quant_conv = nn.Conv2d(dd.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, dd.z_channels, 1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> z_e [N, h, w, embed_dim]."""
        return conv_nhwc(self.quant_conv, self.encoder(x))

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q [N, h, w, embed_dim] -> [N, H, W, out_ch]."""
        z_q = z_q.to(self.post_quant_conv.weight.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z_q))

    def get_last_layer(self) -> torch.Tensor:
        """The decoder's last conv weight (the adaptive GAN weight's layer)."""
        return self.decoder.conv_out.weight


@ARCH_REGISTRY.register()
class RQVAE(_RQAutoEncoder):
    """2-D image RQ-VAE (reference rqvae_arch.py:779-931).

    forward(x [N, H, W, 3], code_only, train, generator) -> (out [N, H, W, 3]
    | z_q, commitment loss, codes [N, h, w, depth]).  With `train` the
    quantizer takes its EMA codebook step (restarts drawn from `generator`).
    With the constructor's `generator`, every weight is initialized from it;
    `group`: the ranks of the quantizer's EMA update."""

    def __init__(self, cfg: VQVAEConfig, generator: Optional[torch.Generator] = None,
                 group=None):
        super().__init__(cfg, group)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor, code_only: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        z_q, quant_loss, codes = self.quantizer(self.encode(x), train=train,
                                                generator=generator)
        if code_only:
            return z_q, quant_loss, codes
        return self.decode(z_q), quant_loss, codes

    def get_codes(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, H, W, 3] -> codes [N, h, w, depth]."""
        return self.quantizer(self.encode(x))[2]

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [N, h, w, depth] -> [N, H, W, out_ch]."""
        return self.decode(self.quantizer.embed_code(codes))
