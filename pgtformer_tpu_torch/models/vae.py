"""The temporal RQ-VAE and its encoder / decoder towers (PyTorch port).

Counterparts of the JAX package's ``models/vae.py`` ``Encoder3D``,
``Decoder3D`` and ``TDCRQVAE3`` (the stage-I autoencoder: encode ->
residual quantize -> decode, and the code path ``get_codes`` /
``decode_code``) on channels-last video tensors, with the reference module
names (``down.{i}.block.{j}``, ``down.{i}.attn.{j}``, ``mid.block_1``,
``up.{i}.upsample``, ...).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.config import DDConfig, VQVAEConfig
from pgtformer_tpu_torch.models.quantizer import RQBottleneck
from pgtformer_tpu_torch.nn.blocks import (
    Downsample, EncoderLayer, GroupNorm, ResnetBlock, Upsample, conv_nhwc, init_weights)
from pgtformer_tpu_torch.ops.fused_conv import fused_decoder_tail, subpixel_up_conv3x3


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
    one frame; the output is then [B, H, W, out_ch].

    Knob ``FUSED_TAIL`` selects the fused kernels of ``ops/fused_conv.py``
    for the upsamples (``up``) or for the whole middle-frame tail (``1``).
    They apply under bf16 inference (no gradient is recorded) to an upsample
    with a conv whose input has H divisible by 8 and C by 128; ``1`` also
    needs the level-1 upsample on one frame per window, one resblock per
    level, H divisible by 16 and no attention or fuse stage at the last
    resolution.  Anywhere else, and under fp32, the knob is ignored and the
    stock modules run.  The device of the tensor, not a flag of the model,
    decides between kernel and plain version inside the wrappers: a bf16
    model on the CPU with the knob set runs the same chain through the plain
    versions."""

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
                tail_mode = knobs.get("FUSED_TAIL")
                B5, T5, H5, W5, C5 = h.shape
                # bf16 only: the kernels round to bf16 inside, which under
                # fp32 would silently lower the tail's precision
                kernels_ok = (tail_mode != "0" and h.dtype == torch.bfloat16
                              and not torch.is_grad_enabled() and cfg.resamp_with_conv
                              and H5 % 8 == 0 and C5 % 128 == 0)
                if kernels_ok and tail_mode == "up":
                    # a view where the middle frame was just sliced out: the
                    # kernel takes the batch stride, no copy is made
                    y, _ = subpixel_up_conv3x3(h.reshape(B5 * T5, H5, W5, C5),
                                               *level.upsample.kernel_weights(),
                                               emit_stats=False)
                    h = y.reshape(B5, T5, 2 * H5, 2 * W5, C5)
                    curr_res *= 2
                    continue
                if (kernels_ok and tail_mode == "1" and i_level == 1 and t_cur == 1
                        and cfg.num_res_blocks == 1 and H5 % 16 == 0
                        and 2 * curr_res not in cfg.attn_resolutions
                        and 2 * curr_res not in fuse_set):
                    # upsample, both level-0 resblocks, norm_out and SiLU as
                    # one chain of fused kernels
                    tail = self.up[0]
                    y = fused_decoder_tail(
                        h.reshape(B5 * T5, H5, W5, C5), level.upsample.kernel_weights(),
                        tail.block[0].kernel_weights(), tail.block[1].kernel_weights(),
                        (self.norm_out.weight.float(), self.norm_out.bias.float()))
                    return conv_nhwc(self.conv_out, y)
                h = level.upsample(h)
                curr_res *= 2

        B5, T5, Hc, Wc, Cc = h.shape
        h = F.silu(self.norm_out(h.reshape(B5 * T5, Hc, Wc, Cc)))
        return conv_nhwc(self.conv_out, h)


class TDCRQVAE3(nn.Module):
    """Temporal RQ-VAE, the stage-I autoencoder.

    forward(x [B, T, H, W, 3], code_only, train) -> (out [B*T, H, W, 3] |
    z_q, commitment loss, codes [B*T, h, w, depth]).  With `train` the
    quantizer takes its EMA codebook step (restarts drawn from the forward's
    `generator`); without it no buffer changes.  With `generator`, every
    weight is initialized from it.  `group`: the ranks over which the
    quantizer's EMA update runs (data-parallel training)."""

    def __init__(self, cfg: VQVAEConfig, generator: Optional[torch.Generator] = None,
                 group=None):
        super().__init__()
        if cfg.loss_type not in ("mse", "l1"):
            raise ValueError(f"loss_type {cfg.loss_type!r} (choices: mse, l1)")
        if cfg.bottleneck_type != "rq":
            raise ValueError("invalid 'bottleneck_type' (must be 'rq')")
        self.cfg = cfg
        dd = cfg.ddconfig
        self.encoder = Encoder3D(dd, num_frames=cfg.tf)
        self.decoder = Decoder3D(dd, num_frames=cfg.tf)
        self.quantizer = RQBottleneck(cfg.latent_shape, cfg.code_shape, cfg.n_embed, cfg.decay,
                                      cfg.shared_codebook, cfg.restart_unused_codes, group=group)
        self.quant_conv = nn.Conv2d(dd.z_channels, cfg.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, dd.z_channels, 1)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor, code_only: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        z_e = self.encode(x)
        z_q, quant_loss, codes = self.quantizer(z_e, train=train, generator=generator)
        if code_only:
            return z_q, quant_loss, codes
        return self.decode(z_q), quant_loss, codes

    def encode(self, x: torch.Tensor, return_multi_res_feats: bool = False):
        """x [B, T, H, W, 3] -> z_e [B*T, h, w, embed_dim] (+ per-level
        encoder features)."""
        if return_multi_res_feats:
            h, feats = self.encoder(x, return_multi_res_feats=True)
            return conv_nhwc(self.quant_conv, h), feats
        return conv_nhwc(self.quant_conv, self.encoder(x))

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q [B*T, h, w, embed_dim] -> [B*T, H, W, out_ch]."""
        z_q = z_q.to(self.post_quant_conv.weight.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z_q))

    def get_codes(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, H, W, 3] -> codes [B*T, h, w, depth]."""
        return self.quantizer(self.encode(x))[2]

    def get_codesbt(self, xs: torch.Tensor) -> torch.Tensor:
        """Reference-named alias of :meth:`get_codes` for an explicit
        [B, T, H, W, 3] clip."""
        return self.get_codes(xs)

    def get_codes_flat(self, x_flat: torch.Tensor) -> torch.Tensor:
        """Codes for a flattened [B*T, H, W, 3] frame batch, re-folded by
        the configured window length."""
        BT, H, W, C = x_flat.shape
        T = self.cfg.tf
        return self.get_codes(x_flat.reshape(BT // T, T, H, W, C))

    def get_soft_codes(self, x: torch.Tensor, temp: float = 1.0, stochastic: bool = False,
                       generator: Optional[torch.Generator] = None):
        return self.quantizer.get_soft_codes(self.encode(x), temp=temp,
                                             stochastic=stochastic, generator=generator)

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantizer.embed_code(codes))

    def decode_partial_code(self, codes: torch.Tensor, code_idx: int,
                            decode_type: str = "select") -> torch.Tensor:
        return self.decode(self.quantizer.embed_partial_code(codes, code_idx, decode_type))

    def forward_partial_code(self, x: torch.Tensor, code_idx: int,
                             decode_type: str = "select") -> torch.Tensor:
        """Reconstruct x from the first codebooks only."""
        return self.decode_partial_code(self.get_codes(x), code_idx, decode_type)

    def get_code_emb_with_depth(self, codes: torch.Tensor):
        """Per-depth code embeddings."""
        return self.quantizer.embed_code_with_depth(codes)

    @staticmethod
    def get_recon_imgs(xs_real: torch.Tensor, xs_recon: torch.Tensor):
        """[-1,1] -> [0,1] display mapping."""
        return xs_real * 0.5 + 0.5, (xs_recon * 0.5 + 0.5).clamp(0.0, 1.0)

    def compute_loss(self, out, quant_loss, codes, xs, valid: bool = False) -> Dict:
        """Reconstruction + weighted commitment loss (forward value)."""
        diff = out.float() - xs.float()
        loss_recon = (diff ** 2).mean() if self.cfg.loss_type == "mse" else diff.abs().mean()
        loss_latent = quant_loss
        if valid:
            loss_recon = loss_recon * xs.shape[0] * xs.shape[1]
            loss_latent = loss_latent * xs.shape[0]
        total = loss_recon + self.cfg.latent_loss_weight * loss_latent
        return {"loss_total": total, "loss_recon": loss_recon,
                "loss_latent": loss_latent, "codes": [codes]}
