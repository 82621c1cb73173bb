"""NIQE (Natural Image Quality Evaluator), BasicSR-compatible (the port's
copy of the JAX package's numpy/cv2 ``eval/niqe.py``).

Full algorithm implementation (MSCN coefficients -> AGGD feature fits over
96x96 blocks at two scales -> Mahalanobis distance to the pristine MVG
model).  The pristine-model parameters (`mu_pris_param`, `cov_pris_param`,
`gaussian_window`) must be supplied as an .npz (BasicSR ships
`niqe_pris_params.npz`; it is not in this repository) -- pass its path to
`calculate_niqe`, or fit a model from a corpus with `fit_pris_params`.
An image smaller than one 96x96 block has no blocks and scores NaN.
"""

from __future__ import annotations

import math
import numpy as np


_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)


def _precompute_rgam():
    g = _GAMMA_RANGE
    num = np.array([math.gamma(2 / x) for x in g]) ** 2
    den = (np.array([math.gamma(1 / x) for x in g])
           * np.array([math.gamma(3 / x) for x in g]))
    return num / den


_RGAM = _precompute_rgam()


def estimate_aggd_param(block: np.ndarray):
    """Asymmetric generalized Gaussian fit -> (alpha, beta_l, beta_r)."""
    block = block.ravel()
    left = block[block < 0]
    right = block[block >= 0]
    left_std = np.sqrt(np.mean(left ** 2)) if left.size else 0.0
    right_std = np.sqrt(np.mean(right ** 2)) if right.size else 0.0
    gammahat = left_std / right_std if right_std > 0 else np.inf
    rhat = (np.mean(np.abs(block)) ** 2) / np.mean(block ** 2)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)
                / ((gammahat ** 2 + 1) ** 2))
    alpha = _GAMMA_RANGE[np.argmin((_RGAM - rhatnorm) ** 2)]
    g1 = math.gamma(1 / alpha)
    g3 = math.gamma(3 / alpha)
    beta_l = left_std * np.sqrt(g1 / g3)
    beta_r = right_std * np.sqrt(g1 / g3)
    return alpha, beta_l, beta_r


def compute_feature(block: np.ndarray) -> list:
    feat = []
    alpha, beta_l, beta_r = estimate_aggd_param(block)
    feat.extend([alpha, (beta_l + beta_r) / 2])
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = np.roll(block, shift, axis=(0, 1))
        alpha, beta_l, beta_r = estimate_aggd_param(block * shifted)
        mean = (beta_r - beta_l) * (math.gamma(2 / alpha)
                                    / math.gamma(1 / alpha))
        feat.extend([alpha, mean, beta_l, beta_r])
    return feat


def _gaussian_window(size=7, sigma=7 / 6):
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def image_niqe_features(img: np.ndarray, crop_border: int = 0,
                        window: np.ndarray | None = None) -> np.ndarray:
    """Two-scale 36-dim NIQE block features for one image.

    img: float [0,1] HWC RGB (converted to gray) or HW gray.  Returns
    [num_blocks, 36]; independent of any pristine model, so the same
    features serve scoring (`niqe_from_features`) and pristine-model
    fitting (`fit_pris_params`).
    """
    import cv2
    if window is None:
        window = _gaussian_window()
    if img.ndim == 3:
        img = img @ np.array([65.481, 128.553, 24.966]) + 16.0
    else:
        img = img * 255.0
    if crop_border:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    img = np.round(img).astype(np.float64)

    block = 96
    h, w = img.shape
    num_bh, num_bw = h // block, w // block
    img = img[:num_bh * block, :num_bw * block]

    feats = []
    for scale in (1, 2):
        mu = cv2.filter2D(img, -1, window, borderType=cv2.BORDER_REPLICATE)
        sigma = np.sqrt(np.abs(
            cv2.filter2D(img ** 2, -1, window,
                         borderType=cv2.BORDER_REPLICATE) - mu ** 2))
        mscn = (img - mu) / (sigma + 1)
        f_scale = []
        b = block // scale
        for i in range(num_bh):
            for j in range(num_bw):
                f_scale.append(compute_feature(
                    mscn[i * b:(i + 1) * b, j * b:(j + 1) * b]))
        feats.append(np.array(f_scale))
        if scale == 1:
            img = cv2.resize(img / 255.0, (img.shape[1] // 2,
                                           img.shape[0] // 2),
                             interpolation=cv2.INTER_LINEAR) * 255.0
    return np.concatenate(feats, axis=1)


def niqe_from_features(feats: np.ndarray, mu_pris: np.ndarray,
                       cov_pris: np.ndarray) -> float:
    """Mahalanobis distance of one image's block features to a pristine
    MVG model (the NIQE score)."""
    mu_dist = np.nanmean(feats, axis=0)
    dist_no_nan = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(dist_no_nan, rowvar=False)
    pinv = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ pinv @ d))


def fit_pris_params(feats_list):
    """Fit the pristine MVG (mu, cov) from per-image feature arrays.

    This is how the published model was built (an MVG over block features
    of a pristine-image corpus) — but fitting from a different corpus
    (e.g. an eval set's GT frames) yields scores NOT comparable to the
    published `niqe_pris_params.npz` model; label such scores clearly.
    """
    rows = np.concatenate(list(feats_list), axis=0)
    mu = np.nanmean(rows, axis=0)
    cov = np.cov(rows[~np.isnan(rows).any(axis=1)], rowvar=False)
    return mu, cov


def calculate_niqe(img: np.ndarray, pris_params_path: str,
                   crop_border: int = 0) -> float:
    """img: float [0,1] HWC RGB (converted to gray) or HW gray."""
    data = np.load(pris_params_path)
    window = data.get("gaussian_window", _gaussian_window())
    feats = image_niqe_features(img, crop_border, window)
    return niqe_from_features(feats, data["mu_pris_param"],
                              data["cov_pris_param"])
