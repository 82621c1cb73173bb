"""The 3-D (temporal-window) Video-Swin layer (PyTorch port).

Counterpart of the JAX package's ``nn/swin3d.py`` (reference modules/swin.py;
only ``BasicLayer`` is consumed, by TDRQVAE's latent-space temporal mixing):
true 3-D windows (Wd, Wh, Ww) over channels-last [B, T, H, W, C], fused-qkv
attention with a 3-D relative-position bias, alternating-shift stacks, the
patch merging and embedding of the Video-Swin trunk.  Masks and bias
indices are numpy constants, cached per geometry.  JAX computes this layer
with XLA einsums (no Pallas kernel), so it is plain PyTorch on every device.

A window is clamped to the input where an axis is no longer than it (and
that axis's shift dropped), which sizes the bias table, a parameter.  flax
creates the table at the first call; here a block is built for an
`input_size` (D, H, W) when one is given, and refuses an input whose
clamped window differs from the one it was built with.  The patch
embedding's ``proj.weight`` keeps the flax kernel layout [pd, ph, pw, in,
out], the layout the weight bridge emits for a 3-D conv.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import layer_norm

Win = Tuple[int, int, int]


def window_partition_3d(x: torch.Tensor, win: Win) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, Wd*Wh*Ww, C] (reference swin.py:38-49)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = win
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse_3d(windows: torch.Tensor, win: Win, B: int, D: int, H: int,
                      W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition_3d`."""
    wd, wh, ww = win
    C = windows.shape[-1]
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index_3d(win: Win) -> np.ndarray:
    """int32 [N, N] indices into a (2Wd-1)(2Wh-1)(2Ww-1)-row bias table
    (reference swin.py:112-126)."""
    wd, wh, ww = win
    dd, hh, wwx = np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")
    coords = np.stack([dd.ravel(), hh.ravel(), wwx.ravel()])
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def compute_mask_3d(Dp: int, Hp: int, Wp: int, win: Win, shift: Win) -> np.ndarray:
    """fp32 [nW, N, N] additive SW-MSA mask of 0 / -100 (reference
    swin.py:312-325)."""
    img = np.zeros((Dp, Hp, Wp), np.float32)
    cnt = 0
    for d in (slice(None, -win[0]), slice(-win[0], -shift[0] or None),
              slice(-shift[0] if shift[0] else 0, None)):
        for h in (slice(None, -win[1]), slice(-win[1], -shift[1] or None),
                  slice(-shift[1] if shift[1] else 0, None)):
            for w in (slice(None, -win[2]), slice(-win[2], -shift[2] or None),
                      slice(-shift[2] if shift[2] else 0, None)):
                img[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = win
    m = img.reshape(Dp // wd, wd, Hp // wh, wh, Wp // ww, ww)
    m = m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))


def clamp_window(size: Win, window: Win, shift: Win) -> Tuple[Win, Win]:
    """The window and shift a block uses on an input of `size` (D, H, W):
    an axis no longer than its window takes its length, and no shift."""
    win, sh = list(window), list(shift)
    for i, s in enumerate(size):
        if s <= win[i]:
            win[i] = s
            sh[i] = 0
    return tuple(win), tuple(sh)


class WindowAttention3DFused(nn.Module):
    """Fused-qkv 3-D window attention with a relative-position bias
    (reference swin.py:85-170).  I/O [B*nW, N, C]; optional additive mask
    [nW, N, N] (numpy)."""

    def __init__(self, dim: int, window_size: Win, num_heads: int, qkv_bias: bool = False,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        wd, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index_3d(self.window_size), dtype=torch.long),
            persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def init_extra(self, g: torch.Generator) -> None:
        t = self.relative_position_bias_table
        with torch.no_grad():
            t.copy_((torch.randn(t.shape, generator=g) * 0.02).clamp_(-0.04, 0.04))

    def forward(self, x: torch.Tensor, mask: Optional[np.ndarray] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x)
        q = qkv[..., :C].reshape(Bn, N, h, hd) * self.scale
        k = qkv[..., C:2 * C].reshape(Bn, N, h, hd)
        v = qkv[..., 2 * C:].reshape(Bn, N, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        idx = self.relative_position_index
        bias = self.relative_position_bias_table[idx.reshape(-1)].reshape(N, N, h)
        attn = attn + bias.permute(2, 0, 1)[None].float()
        if mask is not None:
            nW = mask.shape[0]
            m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
            attn = (attn.reshape(Bn // nW, nW, h, N, N) + m[None, :, None]).reshape(Bn, h, N, N)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        return self.proj(out.reshape(Bn, N, C).to(x.dtype))


class SwinTransformerBlock3D(nn.Module):
    """LN -> (3-D shift) -> W-MSA -> residual, LN -> MLP (``mlp_fc1``,
    exact GELU, ``mlp_fc2``) -> residual (reference swin.py:173-276), on
    [B, D, H, W, C]; pads each axis up to its window and crops after."""

    def __init__(self, dim: int, num_heads: int, window_size: Win = (2, 7, 7),
                 shift_size: Win = (0, 0, 0), mlp_ratio: float = 4.0, qkv_bias: bool = False,
                 input_size: Optional[Win] = None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        win = (clamp_window(input_size, self.window_size, self.shift_size)[0]
               if input_size is not None else self.window_size)
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3DFused(dim, win, num_heads, qkv_bias)
        self.norm2 = layer_norm(dim)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        win, shift = clamp_window((D, H, W), self.window_size, self.shift_size)
        if win != self.attn.window_size:
            raise NotImplementedError(
                f"SwinTransformerBlock3D built for {self.attn.window_size} windows, got a "
                f"{D}x{H}x{W} input (window {win}): build it with input_size=")
        pads = [(-s) % w for s, w in zip((D, H, W), win)]
        Dp, Hp, Wp = D + pads[0], H + pads[1], W + pads[2]
        mask = compute_mask_3d(Dp, Hp, Wp, win, shift) if any(shift) else None

        shortcut = x
        x = self.norm1(x)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        if mask is not None:
            x = torch.roll(x, (-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
        x = window_reverse_3d(self.attn(window_partition_3d(x, win), mask), win, B, Dp, Hp, Wp)
        if mask is not None:
            x = torch.roll(x, shift, dims=(1, 2, 3))
        x = shortcut + x[:, :D, :H, :W, :]
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class PatchMerging3D(nn.Module):
    """2x2 spatial patch merging: [B, D, H, W, C] -> [B, D, H/2, W/2, 2C]
    (odd H or W padded; reference swin.py:279-309)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = layer_norm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[2:4]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer3D(nn.Module):
    """`depth` 3-D Swin blocks, shift 0 / window//2 alternating, then an
    optional :class:`PatchMerging3D` (reference swin.py:328-409).  I/O
    [B, T, H, W, C] (channels-last, where the reference takes B, C, D, H,
    W).  `input_size` (T, H, W) sizes the blocks' clamped windows."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: Win = (1, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = False, downsample: bool = False,
                 input_size: Optional[Win] = None):
        super().__init__()
        half = tuple(w // 2 for w in window_size)
        self.blocks = nn.ModuleList([
            SwinTransformerBlock3D(dim, num_heads, tuple(window_size),
                                   (0, 0, 0) if i % 2 == 0 else half, mlp_ratio, qkv_bias,
                                   input_size)
            for i in range(depth)])
        self.downsample = PatchMerging3D(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return self.downsample(x) if self.downsample is not None else x


class _Conv3dParams(nn.Module):
    """A 3-D conv's kernel in the flax layout [pd, ph, pw, in, out] and its
    bias."""

    def __init__(self, patch: Win, in_chans: int, out_chans: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(*patch, in_chans, out_chans))
        self.bias = nn.Parameter(torch.zeros(out_chans))

    def init_extra(self, g: torch.Generator) -> None:
        fan_in = self.weight[..., 0].numel()
        with torch.no_grad():
            self.weight.copy_(torch.randn(self.weight.shape, generator=g) * fan_in ** -0.5)


class PatchEmbed3D(nn.Module):
    """Video to patch tokens by a strided 3-D conv (each axis padded up to
    its patch), then an optional LayerNorm: [B, T, H, W, C] ->
    [B, T/pd, H/ph, W/pw, embed_dim]."""

    def __init__(self, patch_size: Win = (2, 4, 4), in_chans: int = 3, embed_dim: int = 96,
                 use_norm: bool = False):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = _Conv3dParams(self.patch_size, in_chans, embed_dim)
        self.norm = layer_norm(embed_dim) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pd, ph, pw = self.patch_size
        D, H, W = x.shape[1:4]
        pads = ((-D) % pd, (-H) % ph, (-W) % pw)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        w = self.proj.weight.permute(4, 3, 0, 1, 2).to(x.dtype)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, self.proj.bias.to(x.dtype),
                     stride=self.patch_size)
        y = y.permute(0, 2, 3, 4, 1)
        return self.norm(y) if self.norm is not None else y


class SwinTransformer3D(nn.Module):
    """Video-Swin trunk: :class:`PatchEmbed3D` (with its LayerNorm), a
    pyramid of :class:`BasicLayer3D` stages (``layers_{i}``, each but the
    last merging patches), a final LayerNorm.  `input_size` (T, H, W) of
    the video sizes every stage's clamped windows."""

    def __init__(self, patch_size: Win = (2, 4, 4), in_chans: int = 3, embed_dim: int = 96,
                 depths: Tuple[int, ...] = (2, 2, 6, 2),
                 num_heads: Tuple[int, ...] = (3, 6, 12, 24), window_size: Win = (2, 7, 7),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 input_size: Optional[Win] = None):
        super().__init__()
        self.patch_embed = PatchEmbed3D(patch_size, in_chans, embed_dim, use_norm=True)
        n = len(depths)
        size = (None if input_size is None else
                tuple(-(-s // p) for s, p in zip(input_size, patch_size)))
        self.num_layers = n
        for i in range(n):
            self.add_module(f"layers_{i}", BasicLayer3D(
                int(embed_dim * 2 ** i), depths[i], num_heads[i], tuple(window_size),
                mlp_ratio, qkv_bias, downsample=i < n - 1, input_size=size))
            if size is not None:
                size = (size[0], -(-size[1] // 2), -(-size[2] // 2))
        self.norm = layer_norm(int(embed_dim * 2 ** (n - 1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
        return self.norm(x)
