"""Shifted-window spatio-temporal attention geometry.

Masks and relative-position indices are NumPy constants computed on the
host once per geometry; window partition/reverse are reshape/permute on
channels-last ``[B, T, H, W, C]`` tensors.  Semantics of the reference
window machinery (rstt_layers.py:55-114, :163-184, :549-568).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def effective_window_shift(hw: Tuple[int, int],
                           window: Tuple[int, int],
                           shift: Tuple[int, int]) -> tuple:
    """Clamp window/shift when the input is not larger than the window."""
    win = list(window)
    sh = list(shift)
    for i, s in enumerate(hw):
        if s <= window[i]:
            win[i] = s
            sh[i] = 0
    return tuple(win), tuple(sh)


def window_partition(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[B, T, H, W, C] -> [B*nW, T*Wh*Ww, C] (token order t-major, then h, w)."""
    B, T, H, W, C = x.shape
    wh, ww = window
    x = x.reshape(B, T, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)
    return x.reshape(B * (H // wh) * (W // ww), T * wh * ww, C)


def window_reverse(windows: torch.Tensor, window: Tuple[int, int],
                   B: int, T: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    wh, ww = window
    C = windows.shape[-1]
    x = windows.reshape(B, H // wh, W // ww, T, wh, ww, C)
    x = x.permute(0, 3, 1, 4, 2, 5, 6)
    return x.reshape(B, T, H, W, C)


@functools.lru_cache(maxsize=None)
def relative_position_index(num_frames_q: int, num_frames_kv: int,
                            window: Tuple[int, int]) -> np.ndarray:
    """int32 [D1*Wh*Ww, D2*Wh*Ww] indices into a bias table of
    (2*D1-1)*(2*Wh-1)*(2*Ww-1) rows (reference rstt_layers.py:168-184)."""
    wh, ww = window
    d_q = np.arange(num_frames_q)
    stride = int((num_frames_q + 1) // num_frames_kv)
    d_kv = np.arange(0, num_frames_q, stride)
    h = np.arange(wh)
    w = np.arange(ww)

    def grid(ds):
        dd, hh, ww_ = np.meshgrid(ds, h, w, indexing="ij")
        return np.stack([dd.ravel(), hh.ravel(), ww_.ravel()])

    cq = grid(d_q)
    ckv = grid(d_kv)
    rel = cq[:, :, None] - ckv[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += num_frames_q - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(num_frames: int, Hp: int, Wp: int,
                        window: Tuple[int, int],
                        shift: Tuple[int, int]) -> np.ndarray:
    """Additive SW-MSA mask: float32 [nW, T*Wh*Ww, T*Wh*Ww] of 0 / -100."""
    wh, ww = window
    img = np.zeros((Hp, Wp), np.float32)
    h_slices = (slice(0, -wh), slice(-wh, -shift[0] or None), slice(-shift[0] or Hp, None))
    w_slices = (slice(0, -ww), slice(-ww, -shift[1] or None), slice(-shift[1] or Wp, None))
    cnt = 0
    for hs in h_slices:
        for ws in w_slices:
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(Hp // wh, wh, Wp // ww, ww).transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    m = np.tile(m, (1, num_frames))
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, np.float32(-100.0), np.float32(0.0))
