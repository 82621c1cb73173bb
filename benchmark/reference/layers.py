"""Plain building blocks of the reference models, in float32 (or, for the
yardstick of the comparison, in bfloat16 throughout).

Channels-last tensors throughout (``[N, H, W, C]`` or ``[B, T, H, W, C]``),
parameters under the names of the reference checkpoints, no kernel, no
cache, no evaluation plan.  Every product (conv, linear, attention) goes
through :func:`conv2d`, :func:`linear` or :func:`matmul`, so that the
control of the comparison (``GEMM_ROUNDING``) can run the same model with
its products' operands rounded to a lower precision.

The caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) before it runs these on a card.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# None: products in float32.  Else a function applied to both operands of
# every product before it is taken (the control's lower precision).
GEMM_ROUNDING: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to 448, as an fp8 GEMM's amax scaling does), back
    in t's dtype."""
    s = t.detach().abs().amax().float().clamp(min=1e-30) / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)


def _r(t: torch.Tensor) -> torch.Tensor:
    return t if GEMM_ROUNDING is None else GEMM_ROUNDING(t)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Conv of an NHWC tensor with an OIHW weight."""
    y = F.conv2d(_r(x).permute(0, 3, 1, 2), _r(w), b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    return F.linear(_r(x), _r(w), b)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(_r(a), _r(b))


class Conv2d(nn.Conv2d):
    """nn.Conv2d's parameters, applied to NHWC input."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.weight, self.bias, self.stride[0], self.padding[0])


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) on NHWC."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), 32, self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


def fold(x: torch.Tensor):
    """[B, T, H, W, C] -> ([B*T, H, W, C], (B, T)); 4-D passes through."""
    if x.dim() == 5:
        B, T = x.shape[:2]
        return x.reshape(B * T, *x.shape[2:]), (B, T)
    return x, None


def unfold(x: torch.Tensor, lead) -> torch.Tensor:
    return x if lead is None else x.reshape(*lead, *x.shape[1:])


class ResnetBlock(nn.Module):
    """GroupNorm, SiLU, conv3x3, twice; a 1x1 shortcut on a channel change."""

    def __init__(self, cin: int, cout: Optional[int] = None, shortcut_name: str = "nin_shortcut"):
        super().__init__()
        cout = cout or cin
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.shortcut_name = shortcut_name if cin != cout else None
        if self.shortcut_name:
            self.add_module(shortcut_name, Conv2d(cin, cout, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = fold(x)
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut_name:
            x = getattr(self, self.shortcut_name)(x)
        return unfold(x + h, lead)


class Downsample(nn.Module):
    """Pad right and bottom by one, then a stride-2 conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = fold(x)
        return unfold(self.conv(F.pad(x, (0, 0, 0, 1, 0, 1))), lead)


record_upsample: Optional[Callable] = None     # called with ([N, H, W, C] in, channels out)


class Upsample(nn.Module):
    """Nearest 2x, then conv3x3."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = fold(x)
        if record_upsample is not None:
            record_upsample(tuple(x.shape), self.conv.out_channels)
        y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return unfold(self.conv(y), lead)


def adain(content: torch.Tensor, style: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Adaptive instance normalization on [B, H, W, C]: per sample and
    channel, the spatial mean and unbiased std of `style` given to
    `content`."""
    B, H, W, C = content.shape

    def stats(f):
        flat = f.reshape(B, H * W, C)
        return flat.mean(1).reshape(B, 1, 1, C), \
            (flat.var(1, unbiased=True) + eps).sqrt().reshape(B, 1, 1, C)
    cm, cs = stats(content)
    sm, ss = stats(style)
    return (content - cm) / cs * ss + sm


# -- shifted windows over [B, T, H, W, C] -------------------------------------

def effective_window_shift(hw, window, shift):
    """A map no larger than the window takes the map as its window, unshifted."""
    win, sh = list(window), list(shift)
    for i, s in enumerate(hw):
        if s <= window[i]:
            win[i], sh[i] = s, 0
    return tuple(win), tuple(sh)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """[B, T, H, W, C] -> [B*nW, T*wh*ww, C], tokens t-major."""
    B, T, H, W, C = x.shape
    wh, ww = window
    x = x.reshape(B, T, H // wh, wh, W // ww, ww, C).permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(B * (H // wh) * (W // ww), T * wh * ww, C)


def window_reverse(tok: torch.Tensor, window, B: int, T: int, H: int, W: int) -> torch.Tensor:
    wh, ww = window
    x = tok.reshape(B, H // wh, W // ww, T, wh, ww, -1).permute(0, 3, 1, 4, 2, 5, 6)
    return x.reshape(B, T, H, W, -1)


def relative_position_index(T: int, window) -> np.ndarray:
    """[N, N] indices into a table of (2T-1)(2wh-1)(2ww-1) rows."""
    wh, ww = window
    d, h, w = np.meshgrid(np.arange(T), np.arange(wh), np.arange(ww), indexing="ij")
    c = np.stack([d.ravel(), h.ravel(), w.ravel()])
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0)
    rel = rel + np.array([T - 1, wh - 1, ww - 1])
    return (rel[..., 0] * (2 * wh - 1) * (2 * ww - 1) + rel[..., 1] * (2 * ww - 1)
            + rel[..., 2])


def shifted_window_mask(T: int, H: int, W: int, window, shift) -> np.ndarray:
    """Additive mask [nW, N, N] of 0 / -100: tokens of a rolled window that
    came from different regions of the map do not attend to each other."""
    wh, ww = window
    img = np.zeros((H, W), np.float32)
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -shift[0] or None), slice(-shift[0] or H, None)):
        for ws in (slice(0, -ww), slice(-ww, -shift[1] or None), slice(-shift[1] or W, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(H // wh, wh, W // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    m = np.tile(m, (1, T))
    return np.where(m[:, None, :] != m[:, :, None], np.float32(-100.0), np.float32(0.0))


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, T: int, window, heads: int):
        super().__init__()
        wh, ww = window
        self.T, self.window, self.heads = T, tuple(window), heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * T - 1) * (2 * wh - 1) * (2 * ww - 1), heads))
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        Bn, N, C = x.shape
        h = self.heads
        hd = C // h
        q = self.q(x).reshape(Bn, N, h, hd).transpose(1, 2) * hd ** -0.5
        kv = self.kv(x)
        k = kv[..., :C].reshape(Bn, N, h, hd).transpose(1, 2)
        v = kv[..., C:].reshape(Bn, N, h, hd).transpose(1, 2)
        idx = torch.as_tensor(relative_position_index(self.T, self.window).reshape(-1))
        bias = self.relative_position_bias_table[idx.to(x.device)].reshape(N, N, h)
        attn = matmul(q, k.transpose(-1, -2)) + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]).reshape(Bn, h, N, N)
        out = matmul(torch.softmax(attn, dim=-1), v)
        return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


record_sw_block: Optional[Callable] = None     # called with ([B, T, H, W, C], shift)


class SWTransformerBlock(nn.Module):
    """LN, (shifted) window attention, residual; LN, MLP, residual."""

    def __init__(self, dim: int, heads: int, T: int, window, shift, mlp_ratio: float):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3D(dim, T, window, heads)
        self.norm2 = layer_norm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        window, shift = effective_window_shift((H, W), self.window, self.shift)
        if H % window[0] or W % window[1]:
            raise NotImplementedError(f"{H}x{W} map, {window} window")
        if record_sw_block is not None:
            record_sw_block(tuple(x.shape), shift)
        shifted = any(shift)
        h = self.norm1(x)
        mask = None
        if shifted:
            h = torch.roll(h, (-shift[0], -shift[1]), dims=(2, 3))
            mask = torch.as_tensor(shifted_window_mask(T, H, W, window, shift)).to(x.device, x.dtype)
        out = window_reverse(self.attn(window_partition(h, window), mask), window, B, T, H, W)
        if shifted:
            out = torch.roll(out, shift, dims=(2, 3))
        x = x + out
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class EncoderLayer(nn.Module):
    """`depth` SW blocks, the odd ones shifted by half a window."""

    def __init__(self, dim: int, depth: int, heads: int, T: int, window, mlp_ratio: float):
        super().__init__()
        half = tuple(w // 2 for w in window)
        self.blocks = nn.ModuleList([
            SWTransformerBlock(dim, heads, T, window, (0, 0) if i % 2 == 0 else half, mlp_ratio)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


# -- the code transformer ------------------------------------------------------

record_mha: Optional[Callable] = None           # called with (B, N, heads, head_dim)


class MultiHeadSelfAttention(nn.Module):
    """Packed q/k/v projections (torch.nn.MultiheadAttention's names)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim)

    def forward(self, qk: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        B, N, C = qk.shape
        h, hd = self.heads, C // self.heads
        W, b = self.in_proj_weight, self.in_proj_bias
        split = lambda t: t.reshape(B, N, h, hd).transpose(1, 2)
        q = split(linear(qk, W[:C], b[:C]))
        k = split(linear(qk, W[C:2 * C], b[C:2 * C]))
        vv = split(linear(v, W[2 * C:], b[2 * C:]))
        if record_mha is not None:
            record_mha((B, N, h, hd))
        attn = torch.softmax(matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        return self.out_proj(matmul(attn, vv).transpose(1, 2).reshape(B, N, C))


class TransformerSALayer(nn.Module):
    """Pre-norm: q = k = LN(x) + pos, v = LN(x); then LN, GELU MLP."""

    def __init__(self, dim: int, heads: int, dim_mlp: int):
        super().__init__()
        self.norm1 = layer_norm(dim)
        self.self_attn = MultiHeadSelfAttention(dim, heads)
        self.norm2 = layer_norm(dim)
        self.linear1 = Linear(dim, dim_mlp)
        self.linear2 = Linear(dim_mlp, dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h + pos, h)
        return x + self.linear2(F.gelu(self.linear1(self.norm2(x))))


def load_reference(model: nn.Module, state_dict, device,
                   dtype: torch.dtype = torch.float32) -> nn.Module:
    """Load a reference-format state dict strictly, in `dtype` on `device`."""
    sd = {k: torch.as_tensor(v).to(device=device, dtype=dtype)
          for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def key_shapes(model: nn.Module) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(key, shape) of every entry of a model's state dict."""
    return tuple((k, tuple(v.shape)) for k, v in model.state_dict().items())
