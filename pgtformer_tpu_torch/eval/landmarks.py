"""Pluggable 5-point landmark detection + identity embedding (the port's
copy of the JAX package's ``eval/landmarks.py``) for the face-specific
metrics the reference README reports (Deg / LMD / TLME / MSRL
— reference README.md:127).  The reference repo ships NO implementation of
these metrics or their detectors (README numbers only), so the interfaces
here are pluggable: drop in a real ArcFace embedder / landmark net when
weights are available, and the built-in fallbacks keep every metric column
computable out of the box.

Fallbacks:
  * :class:`ParserLandmarkDetector` — derives the canonical 5 points
    (eye centers, nose tip, mouth corners) from the BiSeNet face-parsing
    map the framework already carries (class centroids / extrema).
  * :class:`GrayPatchEmbedder` — identity-embedding stand-in: normalized
    downsampled grayscale face crop.  Deg computed with it is a proxy;
    swap for ArcFace for paper-comparable numbers.

MSRL: no public definition or implementation exists (the acronym appears
only in the README table).  We implement it as **Multi-Scale Region
Landmark PSNR**: PSNR of landmark-centered crops averaged over landmarks
and dyadic scales — a restoration metric focused on facial-structure
regions, ↑ better, on the same dB scale as the README's ~28 values.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

# CelebAMask-HQ / face-parsing.PyTorch class ids used by the BiSeNet parser
# (reference archs/pgtformer_arch.py BiSeNet: 19 classes)
CLS_L_EYE = 4
CLS_R_EYE = 5
CLS_NOSE = 10
CLS_MOUTH = (11, 12, 13)   # inner mouth, upper lip, lower lip


def _centroid(mask: np.ndarray) -> Optional[np.ndarray]:
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return np.array([xs.mean(), ys.mean()], np.float64)


def landmarks_from_parsing(cls_map: np.ndarray,
                           out_size: float) -> np.ndarray:
    """5-point landmarks [5, 2] (x, y) in `out_size`-pixel coordinates from
    a [h, w] integer parsing map.  Order matches the alignment template:
    left eye, right eye, nose, left mouth corner, right mouth corner."""
    h, w = cls_map.shape
    scale = out_size / np.array([w, h], np.float64)

    le = _centroid(cls_map == CLS_L_EYE)
    re = _centroid(cls_map == CLS_R_EYE)
    no = _centroid(cls_map == CLS_NOSE)
    mouth = np.isin(cls_map, CLS_MOUTH)
    ys, xs = np.nonzero(mouth)
    if len(xs):
        lm = np.array([xs.min(), ys[xs.argmin()]], np.float64)
        rm = np.array([xs.max(), ys[xs.argmax()]], np.float64)
    else:
        lm = rm = None

    center = np.array([w / 2, h / 2], np.float64)
    pts = [p if p is not None else center for p in (le, re, no, lm, rm)]
    return np.stack(pts) * scale


class ParserLandmarkDetector:
    """5-point landmark fallback driven by the framework's own BiSeNet
    parser.  `conditionnet`: the PGTFormer's parser module, or its
    `conditionnet` sub-state-dict (keys without the ``conditionnet.``
    prefix).  Its weights go into a second BiSeNet whose head runs at
    `grid` resolution (the model's own parser emits the prior at the
    latent size), in fp32 on `device` (`cuda` unless given), one image at
    a time; the class map is the argmax of the main head's 19 channels."""

    def __init__(self, conditionnet, grid: int = 64, device=None):
        import torch
        from pgtformer_tpu_torch import resolve_device
        from pgtformer_tpu_torch.convert import load_into
        from pgtformer_tpu_torch.models.parser import BiSeNet

        if isinstance(conditionnet, torch.nn.Module):
            conditionnet = conditionnet.state_dict()
        net = load_into(BiSeNet(out_hw=(grid, grid)), conditionnet)
        self.device = resolve_device(device)
        self.net = net.to(self.device, torch.float32).eval().requires_grad_(False)
        self.grid = grid

    def class_map(self, img: np.ndarray) -> np.ndarray:
        """[H, W, 3] in [0, 1] -> [grid, grid] class ids."""
        import torch
        from pgtformer_tpu_torch.ops.image import imagenet_normalize
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        with torch.no_grad():
            prior = self.net(imagenet_normalize(x[None]))      # [1, g, g, 57]
            return prior[0, :, :, :19].argmax(dim=-1).cpu().numpy()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return landmarks_from_parsing(self.class_map(img), img.shape[0])


class GrayPatchEmbedder:
    """Identity-embedding stand-in: 32x32 grayscale center crop, zero-mean
    unit-norm.  Pluggable — replace with an ArcFace forward for
    paper-comparable Deg numbers."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        import cv2
        h, w = img.shape[:2]
        c = min(h, w)
        y0, x0 = (h - c) // 2, (w - c) // 2
        crop = img[y0:y0 + c, x0:x0 + c]
        g = crop @ np.array([0.299, 0.587, 0.114])
        g = cv2.resize(g.astype(np.float32), (32, 32),
                       interpolation=cv2.INTER_AREA).ravel()
        g = g - g.mean()
        return g / (np.linalg.norm(g) + 1e-12)


def msrl(pred: np.ndarray, gt: np.ndarray, landmarks: np.ndarray,
         base_crop: int = 64,
         scales: Sequence[float] = (1.0, 0.5, 0.25)) -> float:
    """Multi-Scale Region Landmark PSNR (see module docstring).

    pred/gt: [H, W, 3] float [0, 1]; landmarks [5, 2] (x, y) in pixels.
    For each landmark and scale s, PSNR of the (base_crop/s)-pixel crop
    centered there; mean over all (landmark, scale) pairs."""
    from pgtformer_tpu_torch.eval.metrics import calculate_psnr
    H, W = gt.shape[:2]
    vals = []
    for (x, y) in np.asarray(landmarks, np.float64):
        for s in scales:
            half = int(round(base_crop / s)) // 2
            if 2 * half > min(H, W):
                continue  # crop larger than the image: no valid placement
            x0 = int(np.clip(round(x) - half, 0, W - 2 * half))
            y0 = int(np.clip(round(y) - half, 0, H - 2 * half))
            a = pred[y0:y0 + 2 * half, x0:x0 + 2 * half]
            b = gt[y0:y0 + 2 * half, x0:x0 + 2 * half]
            p = calculate_psnr(a, b)
            if np.isfinite(p):
                vals.append(p)
    return float(np.mean(vals)) if vals else float("inf")


def face_metrics_frame(pred: np.ndarray, gt: np.ndarray,
                       detector: Callable, embedder: Callable) -> dict:
    """Per-frame Deg / LMD / MSRL (TLME needs the clip sequence — use
    `temporal_landmark_error` over collected per-frame landmarks)."""
    from pgtformer_tpu_torch.eval.metrics import (
        identity_degradation, landmark_distance)
    lm_pred = detector(pred)
    lm_gt = detector(gt)
    return {
        "deg": identity_degradation(embedder(pred), embedder(gt)),
        "lmd": landmark_distance(lm_pred, lm_gt),
        "msrl": msrl(pred, gt, lm_gt),
        "_lm_pred": lm_pred,
        "_lm_gt": lm_gt,
    }
