"""Reusable blocks on channels-last tensors (PyTorch port).

Counterparts of the JAX package's ``nn/blocks.py``: ResnetBlock,
Downsample, Upsample, Mlp, WindowAttention3D, SWTransformerBlock and
EncoderLayer.  Public I/O is ``[B, T, H, W, C]`` or ``[N, H, W, C]``; convs
run on permuted views (channels_last memory format, no copies).  Parameter
names follow the reference state_dict (``blocks.1.attn.q.weight``, ...).

On a CUDA tensor, :class:`EncoderLayer` runs every block through the
hand-written kernels of ``ops/sw_block.py`` wherever H and W divide by the
window (K1 by default; K3 under ``SW_KERNEL=tokens``, K4 under
``SW_PAIR=1``), and raises otherwise; on the CPU it runs the same math in
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops.fused_conv import (
    ResBlockKernelWeights, conv_kernel_hwio, phase_kernels_2x2)
from pgtformer_tpu_torch.ops.sw_block import (
    SWBlockWeights, sw_block, sw_block_pair, sw_block_tokens)
from pgtformer_tpu_torch.ops.window import (
    effective_window_shift, relative_position_index, shifted_window_mask,
    window_partition, window_reverse)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to [N, H, W, C]."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6, affine) on [N, H, W, C]."""

    def __init__(self, num_channels: int):
        super().__init__(32, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


def layer_norm(dim: int) -> nn.LayerNorm:
    """LayerNorm with the JAX package's eps (1e-6)."""
    return nn.LayerNorm(dim, eps=1e-6)


def _fold(x: torch.Tensor):
    if x.dim() == 5:
        B, T, H, W, C = x.shape
        return x.reshape(B * T, H, W, C), (B, T)
    return x, None


def _unfold(x: torch.Tensor, lead) -> torch.Tensor:
    return x if lead is None else x.reshape(*lead, *x.shape[1:])


class _KernelWeightCache(nn.Module):
    """A module that keeps a derived copy of its weights in the layout of a
    hand-written kernel.  The copy is made at first use and dropped whenever
    the parameters move, change dtype or are loaded."""

    def __init__(self):
        super().__init__()
        self._kernel_cache = None

    def _apply(self, *args, **kwargs):
        self._kernel_cache = None
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kernel_cache = None
        return super()._load_from_state_dict(*args, **kwargs)


class ResnetBlock(_KernelWeightCache):
    """GroupNorm -> SiLU -> conv3x3, twice, with a 1x1 shortcut on a channel
    change (named `nin_shortcut`, or `conv_out` in the Fuse-SFT block)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 shortcut_name: str = "nin_shortcut"):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut_name = shortcut_name if in_channels != out_channels else None
        if self.shortcut_name:
            self.add_module(shortcut_name, nn.Conv2d(in_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        h = conv_nhwc(self.conv1, F.silu(self.norm1(x)))
        h = conv_nhwc(self.conv2, F.silu(self.norm2(h)))
        if self.shortcut_name:
            x = conv_nhwc(getattr(self, self.shortcut_name), x)
        return _unfold(x + h, lead)

    def kernel_weights(self) -> ResBlockKernelWeights:
        """This block's weights for ``ops/fused_conv.py:fused_resblock``
        (cached): fp32 norm affines and biases, bf16 [3, 3, C, Co] kernels."""
        if self._kernel_cache is None:
            f32 = lambda p: p.detach().float().contiguous()
            sc = getattr(self, self.shortcut_name) if self.shortcut_name else None
            self._kernel_cache = ResBlockKernelWeights(
                f32(self.norm1.weight), f32(self.norm1.bias),
                conv_kernel_hwio(self.conv1.weight), f32(self.conv1.bias),
                f32(self.norm2.weight), f32(self.norm2.bias),
                conv_kernel_hwio(self.conv2.weight), f32(self.conv2.bias),
                conv_kernel_hwio(sc.weight)[0, 0] if sc is not None else None,
                f32(sc.bias) if sc is not None else None)
        return self._kernel_cache


class Upsample(_KernelWeightCache):
    """Nearest-2x upsample, then conv3x3."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        if self.with_conv:
            y = self.conv(y)
        return _unfold(y.permute(0, 2, 3, 1), lead)

    def kernel_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bf16 phase kernels [2, 2, 2, 2, C, C], fp32 bias) for
        ``ops/fused_conv.py:subpixel_up_conv3x3`` (cached): the 3x3 kernel
        pre-summed in fp32 into the four 2x2 phase kernels, then rounded."""
        if self._kernel_cache is None:
            k2 = phase_kernels_2x2(self.conv.weight.detach().permute(2, 3, 1, 0))
            self._kernel_cache = (k2.to(torch.bfloat16).contiguous(),
                                  self.conv.bias.detach().float().contiguous())
        return self._kernel_cache


class Downsample(nn.Module):
    """Stride-2 conv3x3 after a (0,1)x(0,1) pad, or 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        y = x.permute(0, 3, 1, 2)
        if self.with_conv:
            y = self.conv(F.pad(y, (0, 1, 0, 1)))
        else:
            y = F.avg_pool2d(y, 2, 2)
        return _unfold(y.permute(0, 2, 3, 1), lead)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention3D(nn.Module):
    """Window self-attention over spatio-temporal window tokens with a 3D
    relative-position bias.  I/O: [B*nW, N, C]; optional additive mask
    [nW, N, N] (numpy)."""

    def __init__(self, dim: int, num_frames: int, window_size: Tuple[int, int],
                 num_heads: int):
        super().__init__()
        self.dim = dim
        self.num_frames = num_frames
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wh, ww = self.window_size
        table = (2 * num_frames - 1) * (2 * wh - 1) * (2 * ww - 1)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(num_frames, num_frames,
                                                    self.window_size), dtype=torch.long),
            persistent=False)
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def init_extra(self, g: torch.Generator) -> None:
        t = self.relative_position_bias_table
        with torch.no_grad():
            t.copy_((torch.randn(t.shape, generator=g) * 0.02).clamp_(-0.04, 0.04))

    def rel_bias(self) -> torch.Tensor:
        """Gathered bias [heads, N, N]."""
        idx = self.relative_position_index
        N = idx.shape[0]
        b = self.relative_position_bias_table[idx.reshape(-1)]
        return b.reshape(N, N, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[np.ndarray] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        h = self.num_heads
        hd = C // h
        q = self.q(x).reshape(Bn, N, h, hd) * (hd ** -0.5)
        kv = self.kv(x)
        k = kv[..., :C].reshape(Bn, N, h, hd)
        v = kv[..., C:].reshape(Bn, N, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        attn = attn + self.rel_bias()[None].float()
        if mask is not None:
            nW = mask.shape[0]
            m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
            attn = (attn.reshape(Bn // nW, nW, h, N, N) + m[None, :, None]).reshape(Bn, h, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        return self.proj(out.reshape(Bn, N, C).to(x.dtype))


class SWTransformerBlock(_KernelWeightCache):
    """(Shifted-)window self-attention block on [B, T, H, W, C]:
    LN -> (shift) -> W-MSA -> LN -> MLP (the reference encoder block)."""

    def __init__(self, dim: int, num_heads: int, num_frames: int,
                 window_size: Tuple[int, int] = (8, 8),
                 shift_size: Tuple[int, int] = (0, 0), mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3D(dim, num_frames, window_size, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def kernel_weights(self, device: torch.device) -> SWBlockWeights:
        """This block's weights for :func:`sw_block`: the live parameters for
        the CPU, bf16/fp32 copies made once (and cached) for CUDA."""
        if self._kernel_cache is not None and self._kernel_cache[0] == device:
            return self._kernel_cache[1]
        a, m = self.attn, self.mlp
        C = a.dim
        with torch.no_grad():
            w = SWBlockWeights(
                self.norm1.weight, self.norm1.bias,
                a.q.weight, a.q.bias, a.kv.weight[:C], a.kv.bias[:C],
                a.kv.weight[C:], a.kv.bias[C:], a.proj.weight, a.proj.bias,
                self.norm2.weight, self.norm2.bias,
                m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
                a.rel_bias(), self.num_heads, self.window_size)
        if device.type == "cpu":
            return w
        w = w.for_kernel()
        self._kernel_cache = (device, w)
        return w

    def _run_windowed(self, x, window, shift, mask):
        """Pad -> cyclic shift -> partition -> attend -> reverse -> crop."""
        B, T, H, W, C = x.shape
        pad_b = (window[0] - H % window[0]) % window[0]
        pad_r = (window[1] - W % window[1]) % window[1]
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3))
        else:
            mask = None
        out = self.attn(window_partition(x, window), mask=mask)
        out = window_reverse(out, window, B, T, Hp, Wp)
        if shifted:
            out = torch.roll(out, (shift[0], shift[1]), dims=(2, 3))
        return out[:, :, :H, :W, :]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        window, shift = effective_window_shift((H, W), self.window_size, self.shift_size)
        if window != self.window_size or T != self.attn.num_frames:
            raise NotImplementedError(
                f"SWTransformerBlock built for {self.attn.num_frames} frames of "
                f"{self.window_size} windows, got T={T} and a {H}x{W} map")
        Hp = -(-H // window[0]) * window[0]
        Wp = -(-W // window[1]) * window[1]
        mask = (shifted_window_mask(T, Hp, Wp, window, shift)
                if any(s > 0 for s in shift) else None)
        x = x + self._run_windowed(self.norm1(x), window, shift, mask)
        return x + self.mlp(self.norm2(x))


class EncoderLayer(nn.Module):
    """`depth` SW blocks with alternating shift (0 / window//2) on
    [B, T, H, W, C].

    Where H and W divide by the window the blocks run through
    ``ops/sw_block.py`` under one of three evaluation plans (knobs
    ``SW_KERNEL`` and ``SW_PAIR``), which all compute the same function:
    one 5-D block per launch (default); roll -> partition -> token block ->
    reverse -> unroll (``tokens``); or each [no-shift, shift] pair of
    blocks in one launch (``SW_PAIR=1`` with ``5d``), any leftover block on
    its own."""

    def __init__(self, dim: int, depth: int, num_heads: int, num_frames: int,
                 window_size: Tuple[int, int] = (8, 8), mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = tuple(window_size)
        half = tuple(w // 2 for w in self.window_size)
        self.blocks = nn.ModuleList([
            SWTransformerBlock(dim, num_heads, num_frames, self.window_size,
                               (0, 0) if i % 2 == 0 else half, mlp_ratio)
            for i in range(depth)])
        self._masks = {}        # (T, H, W, shift, device) -> fp32 mask tensor

    def _apply(self, *args, **kwargs):
        self._masks = {}
        return super()._apply(*args, **kwargs)

    def _mask(self, x: torch.Tensor, shift: Tuple[int, int]) -> torch.Tensor:
        """The shifted-window mask [nW, N, N] as an fp32 tensor on x's
        device, uploaded once per geometry."""
        _, T, H, W, _ = x.shape
        key = (T, H, W, shift, x.device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                shifted_window_mask(T, H, W, self.window_size, shift),
                dtype=torch.float32, device=x.device)
        return self._masks[key]

    def _block_tokens(self, x: torch.Tensor, w: SWBlockWeights,
                      shift: Tuple[int, int]) -> torch.Tensor:
        B, T, H, W, C = x.shape
        win = self.window_size
        shifted = any(s > 0 for s in shift)
        h = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
        tok = sw_block_tokens(window_partition(h, win).contiguous(), w,
                              self._mask(x, shift) if shifted else None,
                              (H // win[0]) * (W // win[1]))
        h = window_reverse(tok, win, B, T, H, W)
        return torch.roll(h, (shift[0], shift[1]), dims=(2, 3)) if shifted else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        wh, ww = self.window_size
        if H % wh == 0 and W % ww == 0:
            x = x.contiguous()
            tokens = knobs.get("SW_KERNEL") == "tokens"
            pair = not tokens and knobs.get("SW_PAIR") == "1"
            shifts = [effective_window_shift((H, W), self.window_size, blk.shift_size)[1]
                      for blk in self.blocks]
            weights = [blk.kernel_weights(x.device) for blk in self.blocks]
            i = 0
            while i < len(self.blocks):
                # a [no-shift, shift] pair; where H or W equals the window the
                # shift is clamped to 0 and the two blocks run on their own
                if (pair and i + 1 < len(self.blocks) and not any(shifts[i])
                        and any(shifts[i + 1])):
                    x = sw_block_pair(x, weights[i], weights[i + 1], shifts[i + 1])
                    i += 2
                    continue
                if tokens:
                    x = self._block_tokens(x, weights[i], shifts[i])
                else:
                    x = sw_block(x, weights[i], shifts[i])
                i += 1
            return x
        if x.is_cuda:
            raise NotImplementedError(
                f"EncoderLayer on CUDA needs H, W divisible by {self.window_size}, "
                f"got {H}x{W}")
        for blk in self.blocks:
            x = blk(x)
        return x


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX package's conventions: fan-in normal conv and
    linear weights, zero biases, unit norms; then each module's own
    `init_extra` (bias tables, codebooks, zero-init heads, BN statistics)."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                normal_(m.weight, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if hasattr(m, "init_extra"):
                m.init_extra(generator)
    return module
