"""Encoder / decoder towers of the temporal RQ-VAE (PyTorch port).

Counterparts of the JAX package's ``models/vae.py`` ``Encoder3D`` and
``Decoder3D`` on channels-last video tensors, with the reference module
names (``down.{i}.block.{j}``, ``down.{i}.attn.{j}``, ``mid.block_1``,
``up.{i}.upsample``, ...).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.config import DDConfig
from pgtformer_tpu_torch.nn.blocks import (
    Downsample, EncoderLayer, GroupNorm, ResnetBlock, Upsample, conv_nhwc)


def _encoder_layer(cfg: DDConfig, dim: int, level: int, num_frames: int) -> EncoderLayer:
    return EncoderLayer(dim, cfg.depths[level], cfg.num_heads[level], num_frames,
                        tuple(cfg.window_sizes[level]), mlp_ratio=1.0)


class _Mid(nn.Module):
    def __init__(self, cfg: DDConfig, dim: int, num_frames: int):
        super().__init__()
        self.block_1 = ResnetBlock(dim)
        self.attn_1 = _encoder_layer(cfg, dim, -1, num_frames)
        self.block_2 = ResnetBlock(dim)


class Encoder3D(nn.Module):
    """Conv tower with spatio-temporal window attention.

    I/O: [B, T, H, W, C_in] -> [B*T, H/2^L, W/2^L, z_channels] (+ per-level
    features).  `stage` splits the tower at the first attention level:
    "trunk" (conv_in + attention-free levels; returns (h, feats)), "head"
    (input is the trunk's h) or "full"."""

    def __init__(self, cfg: DDConfig, num_frames: int = 3):
        super().__init__()
        self.cfg = cfg
        T = num_frames
        self.conv_in = nn.Conv2d(cfg.in_channels, cfg.ch, 3, padding=1)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i, res in enumerate(cfg.level_resolutions()):
            block_out = cfg.ch * cfg.ch_mult[i]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if res in cfg.attn_resolutions:
                    level.attn.append(_encoder_layer(cfg, block_in, i, T))
            if i != cfg.num_resolutions - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv)
            self.down.append(level)
        self.mid = _Mid(cfg, block_in, T)
        self.norm_out = GroupNorm(block_in)
        out_c = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = nn.Conv2d(block_in, out_c, 3, padding=1)

    def _levels(self, h, levels):
        feats: List[torch.Tensor] = []
        for i in levels:
            level = self.down[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            feats.append(h)
            if i != self.cfg.num_resolutions - 1:
                h = level.downsample(h)
        return h, feats

    def forward(self, x: torch.Tensor, return_multi_res_feats: bool = False,
                stage: str = "full"):
        cfg = self.cfg
        if stage not in ("full", "trunk", "head"):
            raise ValueError(f"stage {stage!r}")
        split = cfg.first_attn_level
        feats: List[torch.Tensor] = []
        if stage in ("full", "trunk"):
            B, T, H, W, Cin = x.shape
            h = conv_nhwc(self.conv_in, x.reshape(B * T, H, W, Cin))
            h = h.reshape(B, T, H, W, cfg.ch)
            h, trunk = self._levels(h, range(split))
            feats.extend(trunk)
            if stage == "trunk":
                return h, feats
        else:
            h = x
        h, head = self._levels(h, range(split, cfg.num_resolutions))
        feats.extend(head)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        B, T, Hc, Wc, Cc = h.shape
        h = conv_nhwc(self.conv_out, F.silu(self.norm_out(h.reshape(B * T, Hc, Wc, Cc))))
        if return_multi_res_feats:
            return h, feats
        return h


class Decoder3D(nn.Module):
    """Mirror decoder tower: z [B*T, h, w, z_channels] -> [B*T, H, W, out_ch].

    `fuse_fn(resolution, h, middle_only=False)` is called after each level's
    blocks, before its upsample.  With `middle_only`, the non-middle frames
    are dropped after the last stage that mixes frames (attention, or a
    fuse block at one of `fuse_resolutions`), so the later levels run on
    one frame; the output is then [B, H, W, out_ch]."""

    def __init__(self, cfg: DDConfig, num_frames: int = 3):
        super().__init__()
        self.cfg = cfg
        self.num_frames = num_frames
        block_in = cfg.ch * cfg.ch_mult[-1]
        curr_res = cfg.resolution // 2 ** (cfg.num_resolutions - 1)
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(cfg, block_in, num_frames)
        levels = {}
        for i in reversed(range(cfg.num_resolutions)):
            block_out = cfg.ch * cfg.ch_mult[i]
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(_encoder_layer(cfg, block_in, i, num_frames))
            if i != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv)
                curr_res *= 2
            levels[i] = level
        self.up = nn.ModuleList([levels[i] for i in range(cfg.num_resolutions)])
        self.norm_out = GroupNorm(block_in)
        self.conv_out = nn.Conv2d(block_in, cfg.out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor, fuse_fn: Optional[Callable] = None,
                middle_only: bool = False,
                fuse_resolutions: Tuple[int, ...] = ()) -> torch.Tensor:
        cfg = self.cfg
        T = self.num_frames
        num_res = cfg.num_resolutions
        curr_res = cfg.resolution // 2 ** (num_res - 1)
        BT, hh, ww, _ = z.shape
        B = BT // T

        # slice-point analysis: the last level (in execution order) whose
        # stages need all T frames (attention, or a frame-mixing fuse block)
        fuse_set = set(fuse_resolutions) if fuse_fn is not None else set()
        exec_order = list(reversed(range(num_res)))
        res_at = {}
        r = curr_res
        for i in exec_order:
            res_at[i] = r
            if i != 0:
                r *= 2
        last_na_level = None
        for i in exec_order:
            if res_at[i] in cfg.attn_resolutions or res_at[i] in fuse_set:
                last_na_level = i

        h = self.mid.block_1(conv_nhwc(self.conv_in, z))
        h = h.reshape(B, T, hh, ww, h.shape[-1])
        h = self.mid.block_2(self.mid.attn_1(h))

        t_cur = T
        if middle_only and last_na_level is None:
            h = h[:, T // 2:T // 2 + 1]
            t_cur = 1

        for i_level in exec_order:
            level = self.up[i_level]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            at_slice_level = middle_only and i_level == last_na_level
            if fuse_fn is not None:
                fuse_mid = at_slice_level and curr_res in fuse_set
                h = fuse_fn(curr_res, h, middle_only=fuse_mid)
                if fuse_mid:
                    t_cur = 1
            if at_slice_level and t_cur == T:
                h = h[:, T // 2:T // 2 + 1]
                t_cur = 1
            if i_level != 0:
                h = level.upsample(h)
                curr_res *= 2

        B5, T5, Hc, Wc, Cc = h.shape
        h = F.silu(self.norm_out(h.reshape(B5 * T5, Hc, Wc, Cc)))
        return conv_nhwc(self.conv_out, h)
