"""Evaluation metrics (the port's copy of the JAX package's
``eval/metrics.py``).

PSNR/SSIM reproduce BasicSR's conventions, which the reference's ``val:``
blocks name (``calculate_psnr`` / ``calculate_ssim``): images as float
[0, 1] HWC (RGB), computed on the 0-255 scale in float64, optional border
crop and Y-channel mode.  LPIPS runs the port's VGG16 LPIPS on the device.

Landmark/identity metrics (Deg / LMD / TLME from the reference README's
tables) are pure math given landmarks/embeddings; the detector and
embedding networks are pluggable (``eval/landmarks.py``,
``eval/arcface.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

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


def calculate_lpips_fn(torch_state_dict=None, weights_path=None, device=None):
    """Returns lpips(img, img2) -> float on [0, 1] HWC numpy images, on the
    port's LPIPS (``train/lpips.py``) in fp32 on `device` (`cuda` unless
    given).  `torch_state_dict` / `weights_path`: an
    ``lpips.LPIPS(net='vgg')`` state_dict; without one the VGG is random
    (warns; ``.random_weights`` is set)."""
    import torch
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    fn = make_lpips_fn(torch_state_dict, weights_path=weights_path, device=device)
    dev = fn.module.lin_0.device

    def metric(img, img2):
        a = torch.as_tensor(np.asarray(img, np.float32), device=dev)[None]
        b = torch.as_tensor(np.asarray(img2, np.float32), device=dev)[None]
        with torch.no_grad():
            return float(fn(a, b)[0])

    metric.random_weights = fn.random_weights
    return metric


# -- landmark / identity metrics (pure math over detector outputs) ----------

def landmark_distance(lm_pred: np.ndarray, lm_gt: np.ndarray) -> float:
    """LMD: mean Euclidean distance between landmark sets [N, 2]."""
    return float(np.mean(np.linalg.norm(
        np.asarray(lm_pred) - np.asarray(lm_gt), axis=-1)))


def temporal_landmark_error(lms_pred: np.ndarray,
                            lms_gt: np.ndarray) -> float:
    """TLME: temporal landmark motion error over a clip.

    lms_* : [T, N, 2].  Compares frame-to-frame landmark motion of the
    restoration against the ground truth (stability of facial structure
    over time).
    """
    p = np.asarray(lms_pred, np.float64)
    g = np.asarray(lms_gt, np.float64)
    dp = p[1:] - p[:-1]
    dg = g[1:] - g[:-1]
    return float(np.mean(np.linalg.norm(dp - dg, axis=-1)))


def identity_degradation(emb_pred: np.ndarray, emb_gt: np.ndarray) -> float:
    """Deg: angle (degrees) between identity embeddings (ArcFace-style)."""
    a = np.asarray(emb_pred, np.float64).ravel()
    b = np.asarray(emb_gt, np.float64).ravel()
    cos = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def evaluate_clip(pred: np.ndarray, gt: np.ndarray,
                  lpips_metric: Optional[Callable] = None) -> dict:
    """Frame-averaged PSNR/SSIM(/LPIPS) over [T, H, W, 3] clips."""
    T = pred.shape[0]
    out = {"psnr": np.mean([calculate_psnr(pred[t], gt[t])
                            for t in range(T)]),
           "ssim": np.mean([calculate_ssim(pred[t], gt[t])
                            for t in range(T)])}
    if lpips_metric is not None:
        out["lpips"] = np.mean([lpips_metric(pred[t], gt[t])
                                for t in range(T)])
    return out
