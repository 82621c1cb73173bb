"""PSNR and SSIM (the port's copy of those functions of the JAX package's
``eval/metrics.py``).

They reproduce BasicSR's conventions, which the reference's ``val:`` blocks
name (``calculate_psnr`` / ``calculate_ssim``): images as float [0, 1] HWC
(RGB), computed on the 0-255 scale in float64, optional border crop and
Y-channel mode.
"""

from __future__ import annotations

import numpy as np


def _to_y(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma from RGB in [0,1] -> [16,235]-ish /255 scale."""
    w = np.array([65.481, 128.553, 24.966], img.dtype) / 255.0
    return img @ w + 16.0 / 255.0


def _prep(img, crop_border, test_y_channel):
    img = np.asarray(img, np.float64)
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    if test_y_channel and img.ndim == 3 and img.shape[-1] == 3:
        img = _to_y(img)
    return img * 255.0


def calculate_psnr(img: np.ndarray, img2: np.ndarray, crop_border: int = 0,
                   test_y_channel: bool = False) -> float:
    a = _prep(img, crop_border, test_y_channel)
    b = _prep(img2, crop_border, test_y_channel)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def _ssim_channel(a: np.ndarray, b: np.ndarray) -> float:
    """SSIM with the standard 11x11 sigma=1.5 Gaussian window on the
    0-255 scale (BasicSR convention; valid region only)."""
    import cv2
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    kernel = cv2.getGaussianKernel(11, 1.5)
    window = kernel @ kernel.T

    def filt(x):
        return cv2.filter2D(x, -1, window)[5:-5, 5:-5]

    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(a * a) - mu1_sq
    s2 = filt(b * b) - mu2_sq
    s12 = filt(a * b) - mu12
    m = ((2 * mu12 + c1) * (2 * s12 + c2)
         / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)))
    return float(m.mean())


def calculate_ssim(img: np.ndarray, img2: np.ndarray, crop_border: int = 0,
                   test_y_channel: bool = False) -> float:
    a = _prep(img, crop_border, test_y_channel)
    b = _prep(img2, crop_border, test_y_channel)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    return float(np.mean([_ssim_channel(a[..., c], b[..., c])
                          for c in range(a.shape[-1])]))
