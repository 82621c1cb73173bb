"""Kernel K1: one whole shifted-window transformer block.

Replaces the TPU kernel ``pgtformer_tpu/ops/pallas_attn.py:
_pallas_sw_block_5d`` (via ``fused_sw_block_5d``).  The Hopper kernel is
``csrc/sw_block.cu``: windows of T*wh*ww tokens are read straight from the
``[B, T, H, W, C]`` layout with the half-window roll applied as an address
change, and LN1, attention (head by head), proj, LN2 and the MLP all run
in shared memory.  On an H100 the block is compute-bound on paper
(12*C^2 FLOP per token); this version is held back by wmma fragments whose
weight operands stream from L2: each 48-row CTA (one window) reuses a
weight fragment 3 times, and two CTAs share an SM at C<=256.

:func:`sw_block` launches the kernel for a CUDA tensor and runs
:func:`sw_block_plain`, the same math in plain PyTorch, only for a tensor
on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pgtformer_tpu_torch.ops import _build
from pgtformer_tpu_torch.ops.window import (
    shifted_window_mask, window_partition, window_reverse)


class SWBlockWeights(NamedTuple):
    """One block's weights.  Matrices are (out, in); for the kernel they are
    bf16 and the vectors fp32.  `rel_bias` is the gathered [heads, N, N]
    fp32 relative-position bias."""
    norm1_w: torch.Tensor
    norm1_b: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    rel_bias: torch.Tensor
    num_heads: int
    window: Tuple[int, int]

    def for_kernel(self) -> "SWBlockWeights":
        """bf16 contiguous matrices and fp32 contiguous vectors."""
        mats = {"wq", "wk", "wv", "wp", "w1", "w2"}
        conv = {}
        for name, t in self._asdict().items():
            if isinstance(t, torch.Tensor):
                dt = torch.bfloat16 if name in mats else torch.float32
                t = t.detach().to(dtype=dt).contiguous()
            conv[name] = t
        return SWBlockWeights(**conv)


def _layer_norm(z: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    var = ((zf - mu) ** 2).mean(-1, keepdim=True)
    y = (zf - mu) * torch.rsqrt(var + 1e-6)
    return (y * g.float() + b.float()).to(z.dtype)


def _block_tokens(x: torch.Tensor, w: SWBlockWeights,
                  mask: Optional[np.ndarray], n_windows_per_image: int) -> torch.Tensor:
    """The block on window tokens [M, N, C], in x's dtype with fp32 scores
    (the math of the JAX package's sw_block_tokens_xla)."""
    M, N, C = x.shape
    dt = x.dtype
    h = w.num_heads
    hd = C // h
    lin = lambda z, wt, bs: F.linear(z, wt.to(dt), bs.to(dt))
    hx = _layer_norm(x, w.norm1_w, w.norm1_b)
    q = lin(hx, w.wq, w.bq).reshape(M, N, h, hd) * (hd ** -0.5)
    k = lin(hx, w.wk, w.bk).reshape(M, N, h, hd)
    v = lin(hx, w.wv, w.bv).reshape(M, N, h, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    attn = attn + w.rel_bias[None].float()
    if mask is not None:
        nW = n_windows_per_image
        m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
        attn = (attn.reshape(M // nW, nW, h, N, N) + m[None, :, None]).reshape(M, h, N, N)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).reshape(M, N, C).to(dt)
    x = x + lin(out, w.wp, w.bp)
    f = F.gelu(lin(_layer_norm(x, w.norm2_w, w.norm2_b), w.w1, w.b1))
    return x + lin(f, w.w2, w.b2)


def sw_block_plain(x: torch.Tensor, w: SWBlockWeights,
                   shift: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel on [B, T, H, W, C]: roll ->
    partition -> block -> reverse -> unroll."""
    B, T, H, W, C = x.shape
    window = tuple(w.window)
    shifted = any(s > 0 for s in shift)
    h = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
    tok = window_partition(h, window)
    nW = (H // window[0]) * (W // window[1])
    mask = shifted_window_mask(T, H, W, window, tuple(shift)) if shifted else None
    tok = _block_tokens(tok, w, mask, nW)
    h = window_reverse(tok, window, B, T, H, W)
    return torch.roll(h, (shift[0], shift[1]), dims=(2, 3)) if shifted else h


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("sw_block")
    fn = lib.sw_block_launch
    if fn.argtypes is None:
        # 19 pointers; B T H W C heads wh ww sh sw; scale; stream
        fn.argtypes = [_P] * 19 + [_I] * 10 + [ctypes.c_float, _P]
        fn.restype = _I
    return lib


def sw_block(x: torch.Tensor, w: SWBlockWeights,
             shift: Tuple[int, int]) -> torch.Tensor:
    """One SW transformer block on x [B, T, H, W, C].

    CPU tensor: :func:`sw_block_plain`.  CUDA tensor: the Hopper kernel,
    with `w` prepared by :meth:`SWBlockWeights.for_kernel`; raises on any
    dtype, layout or geometry the kernel does not take."""
    if x.device.type == "cpu":
        return sw_block_plain(x, w, shift)
    if not x.is_cuda:
        raise NotImplementedError(f"sw_block: device {x.device}")
    if x.dtype != torch.bfloat16 or x.dim() != 5 or not x.is_contiguous():
        raise NotImplementedError(
            f"sw_block kernel takes contiguous bf16 [B,T,H,W,C], got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, T, H, W, C = x.shape
    wh, ww = w.window
    heads = w.num_heads
    N = T * wh * ww
    hd = C // heads
    if (C % 64 or C > 512 or C % heads or hd % 16 or hd > 64
            or H % wh or W % ww or N % 16 or 48 % N
            or not (0 <= shift[0] < wh and 0 <= shift[1] < ww)):
        raise NotImplementedError(
            f"sw_block kernel: C={C} heads={heads} window={w.window} "
            f"T={T} H={H} W={W} shift={shift}")
    mats = (w.wq, w.wk, w.wv, w.wp, w.w1, w.w2)
    vecs = (w.norm1_w, w.norm1_b, w.bq, w.bk, w.bv, w.bp, w.norm2_w,
            w.norm2_b, w.b1, w.b2)
    for t in mats:
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (C, C)
                or not t.is_contiguous() or t.device != x.device):
            raise NotImplementedError("sw_block kernel: weights must be bf16 "
                                      "(C, C) contiguous on x's device")
    for t in vecs:
        if (t.dtype != torch.float32 or tuple(t.shape) != (C,)
                or not t.is_contiguous() or t.device != x.device):
            raise NotImplementedError("sw_block kernel: vectors must be fp32 (C,)")
    rb = w.rel_bias
    if (rb.dtype != torch.float32 or tuple(rb.shape) != (heads, N, N)
            or not rb.is_contiguous() or rb.device != x.device):
        raise NotImplementedError("sw_block kernel: rel_bias must be fp32 [h, N, N]")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x, out, w.norm1_w, w.norm1_b, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv,
            w.wp, w.bp, w.norm2_w, w.norm2_b, w.w1, w.b1, w.w2, w.b2, rb]
    code = _lib().sw_block_launch(
        *[t.data_ptr() for t in ptrs], B, T, H, W, C, heads, wh, ww,
        int(shift[0]), int(shift[1]), float(hd ** -0.5), stream)
    _build.check(code, "sw_block launch")
    sw_block.launches += 1
    return out


sw_block.launches = 0
