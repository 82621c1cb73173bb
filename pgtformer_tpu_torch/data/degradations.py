"""Blind-degradation synthesis (host-side, NumPy): the port's copy of the
numpy part of the JAX package's ``data/degradations.py``.

The classic blind face-restoration degradation pipeline the reference ships
(itself from VQFR): random blur kernels (iso/aniso Gaussian, generalized
Gaussian, plateau, sinc), Gaussian/Poisson noise with optional gray noise,
JPEG compression, and MATLAB-compatible bicubic rescaling.

Design deltas from the reference:
  * every sampler takes an explicit `np.random.Generator` — deterministic
    per-sample randomness (the reference uses global `np.random`/`random`
    state, which breaks reproducibility across worker processes);
  * pure NumPy + cv2; per-clip application keeps the same kernel/noise
    across the T frames of a clip when `shared` (temporal consistency).

The same generator, image and arguments give the same arrays as the JAX
package's functions, bit for bit.  That package's batched on-device noise
functions (on `jax.random` keys) are on no path of the training CLI and are
not ported here.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


# -- blur kernels -----------------------------------------------------------

def sigma_matrix(sig_x: float, sig_y: float, theta: float) -> np.ndarray:
    """Rotated 2x2 covariance matrix."""
    d = np.array([[sig_x ** 2, 0.0], [0.0, sig_y ** 2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size: int) -> np.ndarray:
    """[k, k, 2] grid of (x, y) coordinates centered at 0."""
    ax = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(ax, ax)
    return np.stack([xx, yy], axis=-1)


def bivariate_gaussian(kernel_size: int, sig_x: float, sig_y: float = None,
                       theta: float = 0.0, isotropic: bool = True
                       ) -> np.ndarray:
    grid = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", grid, inv, grid))
    return k / k.sum()


def bivariate_generalized_gaussian(kernel_size: int, sig_x: float,
                                   sig_y: float = None, theta: float = 0.0,
                                   beta: float = 1.0,
                                   isotropic: bool = True) -> np.ndarray:
    grid = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    q = np.einsum("hwi,ij,hwj->hw", grid, inv, grid)
    k = np.exp(-0.5 * np.power(q, beta))
    return k / k.sum()


def bivariate_plateau(kernel_size: int, sig_x: float, sig_y: float = None,
                      theta: float = 0.0, beta: float = 1.0,
                      isotropic: bool = True) -> np.ndarray:
    grid = mesh_grid(kernel_size)
    if isotropic:
        sigma = np.array([[sig_x ** 2, 0.0], [0.0, sig_x ** 2]])
    else:
        sigma = sigma_matrix(sig_x, sig_y, theta)
    inv = np.linalg.inv(sigma)
    q = np.einsum("hwi,ij,hwj->hw", grid, inv, grid)
    k = 1.0 / (np.power(q, beta) + 1.0)
    return k / k.sum()


def circular_lowpass_kernel(cutoff: float, kernel_size: int,
                            pad_to: int = 0) -> np.ndarray:
    """2D sinc filter (ideal circular low-pass); kernel_size must be odd."""
    from scipy import special
    assert kernel_size % 2 == 1
    grid = mesh_grid(kernel_size)
    r = np.sqrt(grid[..., 0] ** 2 + grid[..., 1] ** 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = cutoff * special.j1(cutoff * r) / (2 * np.pi * r)
    k[kernel_size // 2, kernel_size // 2] = cutoff ** 2 / (4 * np.pi)
    k = k / k.sum()
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        k = np.pad(k, ((pad, pad), (pad, pad)))
    return k


def random_mixed_kernel(rng: np.random.Generator,
                        kernel_size: int = 21,
                        kernel_list: Sequence[str] = (
                            "iso", "aniso", "generalized_iso",
                            "generalized_aniso", "plateau_iso",
                            "plateau_aniso"),
                        kernel_prob: Sequence[float] = (
                            0.405, 0.225, 0.108, 0.027, 0.108, 0.027),
                        sigma_x_range: Tuple[float, float] = (0.2, 3.0),
                        sigma_y_range: Tuple[float, float] = (0.2, 3.0),
                        rotation_range: Tuple[float, float] = (-math.pi,
                                                               math.pi),
                        betag_range: Tuple[float, float] = (0.5, 4.0),
                        betap_range: Tuple[float, float] = (1.0, 2.0),
                        ) -> np.ndarray:
    """Sample one blur kernel from the kernel-type mixture."""
    kind = rng.choice(list(kernel_list), p=np.asarray(kernel_prob)
                      / np.sum(kernel_prob))
    sx = rng.uniform(*sigma_x_range)
    sy = rng.uniform(*sigma_y_range)
    th = rng.uniform(*rotation_range)
    if kind == "iso":
        return bivariate_gaussian(kernel_size, sx, isotropic=True)
    if kind == "aniso":
        return bivariate_gaussian(kernel_size, sx, sy, th, isotropic=False)
    if kind == "generalized_iso":
        return bivariate_generalized_gaussian(
            kernel_size, sx, beta=rng.uniform(*betag_range), isotropic=True)
    if kind == "generalized_aniso":
        return bivariate_generalized_gaussian(
            kernel_size, sx, sy, th, beta=rng.uniform(*betag_range),
            isotropic=False)
    if kind == "plateau_iso":
        return bivariate_plateau(kernel_size, sx,
                                 beta=rng.uniform(*betap_range),
                                 isotropic=True)
    if kind == "plateau_aniso":
        return bivariate_plateau(kernel_size, sx, sy, th,
                                 beta=rng.uniform(*betap_range),
                                 isotropic=False)
    raise ValueError(kind)


# -- noise ------------------------------------------------------------------
#
# Semantics mirror the reference wrappers (reference data/degradations.py:
# 391-683): sigma on the 0-255 scale; gray noise = one 2D field replicated
# over channels; `rounds` quantizes to the 255 grid after adding; Poisson
# vals = 2^ceil(log2(#unique levels)) of the round-clipped image.
# Deltas: explicit np.random.Generator (reproducible across workers) and
# RGB luma (the reference numpy path grayscales with cv2 BGR weights on what
# is actually an RGB array; we use the correct RGB -> Y).

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


def _finish(img: np.ndarray, noise: np.ndarray, clip: bool,
            rounds: bool) -> np.ndarray:
    out = img + noise.astype(img.dtype)
    if clip and rounds:
        out = np.clip((out * 255.0).round(), 0, 255) / 255.0
    elif clip:
        out = np.clip(out, 0, 1)
    elif rounds:
        out = (out * 255.0).round() / 255.0
    return out


def generate_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                            sigma: float, gray: bool = False) -> np.ndarray:
    # float64 draw cast to float32 (the reference's order) so a seeded
    # np.random.RandomState reproduces its stream bit-exactly
    if gray:
        noise = np.float32(rng.normal(size=img.shape[:2])) * sigma / 255.0
        return np.repeat(noise[:, :, None], img.shape[-1], axis=2)
    return np.float32(rng.normal(size=img.shape)) * sigma / 255.0


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       sigma: float, gray: bool = False,
                       clip: bool = True, rounds: bool = False) -> np.ndarray:
    """img float [H, W, C] in [0,1]; sigma on the 0-255 scale."""
    return _finish(img, generate_gaussian_noise(img, rng, sigma, gray),
                   clip, rounds)


def random_add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                              sigma_range: Tuple[float, float] = (0, 10),
                              gray_prob: float = 0.0, clip: bool = True,
                              rounds: bool = False) -> np.ndarray:
    sigma = rng.uniform(*sigma_range)
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, rng, sigma, gray, clip, rounds)


def _poisson_vals(img: np.ndarray) -> float:
    """2^ceil(log2(#unique gray levels)) of the round-clipped image."""
    q = np.clip((img * 255.0).round(), 0, 255)
    return float(2 ** np.ceil(np.log2(max(len(np.unique(q)), 2))))


def generate_poisson_noise(img: np.ndarray, rng: np.random.Generator,
                           scale: float = 1.0,
                           gray: bool = False) -> np.ndarray:
    src = (img @ _LUMA).astype(np.float32) if gray else img
    q = np.clip((src * 255.0).round(), 0, 255) / 255.0
    vals = _poisson_vals(src)
    noise = np.float32(rng.poisson(q * vals) / vals) - q
    if gray:
        noise = np.repeat(noise[:, :, None], img.shape[-1], axis=2)
    return noise * scale


def add_poisson_noise(img: np.ndarray, rng: np.random.Generator,
                      scale: float = 1.0, gray: bool = False,
                      clip: bool = True, rounds: bool = False) -> np.ndarray:
    """Shot noise with intensity-dependent variance."""
    return _finish(img, generate_poisson_noise(img, rng, scale, gray),
                   clip, rounds)


def random_add_poisson_noise(img: np.ndarray, rng: np.random.Generator,
                             scale_range: Tuple[float, float] = (0, 1.0),
                             gray_prob: float = 0.0, clip: bool = True,
                             rounds: bool = False) -> np.ndarray:
    scale = rng.uniform(*scale_range)
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, rng, scale, gray, clip, rounds)


def random_add_jpeg_compression(img: np.ndarray, rng: np.random.Generator,
                                quality_range: Tuple[float, float] = (90, 100)
                                ) -> np.ndarray:
    return add_jpeg_compression(img, int(rng.uniform(*quality_range)))


def add_jpeg_compression(img: np.ndarray, quality: int) -> np.ndarray:
    """Round-trip through JPEG at the given quality (img float [0,1] RGB)."""
    if cv2 is None:
        raise RuntimeError("cv2 required for JPEG compression")
    u8 = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    ok, enc = cv2.imencode(".jpg", u8[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    assert ok
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)[..., ::-1]
    return dec.astype(np.float32) / 255.0


# -- MATLAB-compatible bicubic resize --------------------------------------

def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _resize_weights(in_len: int, out_len: int, scale: float):
    kernel_width = 4.0
    if scale < 1:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - idx - 1
    if scale < 1:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    keep = ~np.all(w == 0, axis=0)
    return w[:, keep], idx[:, keep]


def imresize_matlab(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB `imresize` (bicubic, antialiasing) on float [H, W, C].

    Matches BasicSR's `matlab_functions.imresize`, which the reference uses
    for the 'lr' x0.25 degradation (reference data/vfhq_full_dataset.py:207).
    """
    H, W = img.shape[:2]
    out_h, out_w = int(np.ceil(H * scale)), int(np.ceil(W * scale))
    wh, ih = _resize_weights(H, out_h, scale)
    ww, iw = _resize_weights(W, out_w, scale)
    # rows
    tmp = (img[ih] * wh[..., None, None]).sum(axis=1)      # [out_h, W, C]
    out = (tmp[:, iw] * ww[None, :, :, None]).sum(axis=2)  # [out_h, out_w, C]
    return out.astype(img.dtype)


# -- the classic pipeline ---------------------------------------------------

def _sample_blur_kernel(rng: np.random.Generator, kernel_size: int,
                        sinc_prob: float) -> np.ndarray:
    """Blur kernel from the mixture, or a 2D sinc with probability
    `sinc_prob` (the Real-ESRGAN-style sinc stage the reference's kernel
    library ships — reference data/degradations.py:364-381)."""
    if rng.uniform() < sinc_prob:
        # small kernels need a higher cutoff floor (ringing otherwise)
        lo = np.pi / 3 if kernel_size < 13 else np.pi / 5
        return circular_lowpass_kernel(rng.uniform(lo, np.pi), kernel_size)
    return random_mixed_kernel(rng, kernel_size)


def blind_degrade_clip(frames: np.ndarray, rng: np.random.Generator,
                       downscale_range: Tuple[float, float] = (1.0, 8.0),
                       sigma_range: Tuple[float, float] = (0.0, 10.0),
                       poisson_scale_range: Tuple[float, float] = (0.05, 2.0),
                       jpeg_range: Tuple[int, int] = (60, 100),
                       kernel_size: int = 21,
                       sinc_prob: float = 0.1,
                       gray_noise_prob: float = 0.0,
                       poisson_prob: float = 0.0,
                       second_order_prob: float = 0.0,
                       final_sinc_prob: float = 0.0,
                       shared: bool = True) -> np.ndarray:
    """Classic blind pipeline — blur -> downsample -> noise -> JPEG ->
    upsample back — with optional sinc blur, gray/Poisson noise, a
    second-order pass (weaker repeat: blur2/noise2/jpeg2), and a final sinc
    filter.  All random draws are shared across the clip's T frames for
    temporal consistency (the reference pre-renders LR_Blind with one
    degradation per clip).

    frames: [T, H, W, 3] float in [0, 1]; returns same shape.
    """
    T, H, W, _ = frames.shape
    kernel = _sample_blur_kernel(rng, kernel_size, sinc_prob)
    scale = rng.uniform(*downscale_range)
    use_poisson = rng.uniform() < poisson_prob
    sigma = rng.uniform(*sigma_range)
    pscale = rng.uniform(*poisson_scale_range)
    gray = rng.uniform() < gray_noise_prob
    quality = int(rng.integers(jpeg_range[0], jpeg_range[1] + 1))

    second = rng.uniform() < second_order_prob
    if second:
        kernel2 = _sample_blur_kernel(rng, kernel_size, sinc_prob)
        sigma2 = rng.uniform(sigma_range[0], sigma_range[1] * 0.5)
        pscale2 = rng.uniform(poisson_scale_range[0],
                              poisson_scale_range[1] * 0.5)
        quality2 = int(rng.integers(jpeg_range[0], jpeg_range[1] + 1))
    final_sinc = rng.uniform() < final_sinc_prob
    if final_sinc:
        sinc_k = circular_lowpass_kernel(rng.uniform(np.pi / 3, np.pi), 11)

    # one noise stream per frame derived from the shared generator, so the
    # noise field varies over time (sensor noise is temporally white) while
    # every *parameter* stays clip-constant
    frame_seeds = rng.integers(0, 2 ** 31, size=(T, 2))

    def add_noise(img, r, sig, psc):
        if use_poisson:
            return add_poisson_noise(img, r, psc, gray=gray)
        return add_gaussian_noise(img, r, sig, gray=gray)

    out = []
    for t in range(T):
        img = frames[t]
        img = cv2.filter2D(img, -1, kernel)
        small = cv2.resize(img, (int(W / scale), int(H / scale)),
                           interpolation=cv2.INTER_LINEAR)
        r = (rng if shared else np.random.default_rng(frame_seeds[t, 0]))
        small = add_noise(small, r, sigma, pscale)
        small = add_jpeg_compression(small, quality)
        if second:
            small = cv2.filter2D(small, -1, kernel2)
            r2 = (rng if shared else np.random.default_rng(frame_seeds[t, 1]))
            small = add_noise(small, r2, sigma2, pscale2)
            small = add_jpeg_compression(small, quality2)
        img = cv2.resize(small, (W, H), interpolation=cv2.INTER_LINEAR)
        if final_sinc:
            img = cv2.filter2D(img, -1, sinc_k)
        out.append(np.clip(img, 0.0, 1.0))
    return np.stack(out).astype(np.float32)
