"""Window and image ops of the PyTorch port against the JAX package's.
Masks and indices must be exact; values agree to atol 1e-6 (fp32)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.ops.image as jimg
import pgtformer_tpu.ops.window as jwin
import pgtformer_tpu_torch.ops.image as timg
import pgtformer_tpu_torch.ops.window as twin
from pgtformer_tpu.pipeline import _rgb_to_yuv420 as jax_yuv
from pgtformer_tpu_torch.pipeline import _rgb_to_yuv420 as torch_yuv

RNG = np.random.default_rng(0)


def _close(a, b, atol=1e-6):
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), atol=atol, rtol=1e-6)


@pytest.mark.parametrize("hw,window,shift", [
    ((16, 16), (4, 4), (2, 2)), ((4, 8), (4, 4), (2, 2)), ((3, 3), (4, 4), (2, 2))])
def test_effective_window_shift(hw, window, shift):
    assert twin.effective_window_shift(hw, window, shift) == \
        jwin.effective_window_shift(hw, window, shift)


@pytest.mark.parametrize("tq,tkv,window", [(3, 3, (4, 4)), (1, 1, (4, 4)), (3, 3, (2, 3))])
def test_relative_position_index_exact(tq, tkv, window):
    np.testing.assert_array_equal(twin.relative_position_index(tq, tkv, window),
                                  jwin.relative_position_index(tq, tkv, window))


@pytest.mark.parametrize("T,H,W,window,shift", [
    (3, 8, 8, (4, 4), (2, 2)), (1, 16, 12, (4, 4), (2, 2)), (3, 12, 8, (4, 4), (2, 0))])
def test_shifted_window_mask_exact(T, H, W, window, shift):
    np.testing.assert_array_equal(twin.shifted_window_mask(T, H, W, window, shift),
                                  jwin.shifted_window_mask(T, H, W, window, shift))


def test_window_partition_reverse():
    x = RNG.normal(size=(2, 3, 8, 12, 5)).astype(np.float32)
    ours = twin.window_partition(torch.from_numpy(x), (4, 4))
    _close(ours, jwin.window_partition(jnp.asarray(x), (4, 4)))
    back = twin.window_reverse(ours, (4, 4), 2, 3, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)


def test_imagenet_normalize_and_pool():
    x = RNG.uniform(size=(2, 5, 7, 3)).astype(np.float32)
    _close(timg.imagenet_normalize(torch.from_numpy(x)), jimg.imagenet_normalize(jnp.asarray(x)))
    _close(timg.global_avg_pool(torch.from_numpy(x)), jimg.global_avg_pool(jnp.asarray(x)))


def test_adaptive_instance_normalization():
    c = RNG.normal(size=(3, 8, 8, 16)).astype(np.float32)
    s = (RNG.normal(size=(3, 8, 8, 16)) * 2 + 1).astype(np.float32)
    _close(timg.adaptive_instance_normalization(torch.from_numpy(c), torch.from_numpy(s)),
           jimg.adaptive_instance_normalization(jnp.asarray(c), jnp.asarray(s)), atol=1e-5)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((5, 7), (3, 4)), ((2, 3), (5, 7)),
                                     ((1, 1), (4, 4))])
def test_resize_nearest(src, dst):
    x = RNG.normal(size=(2, *src, 3)).astype(np.float32)
    _close(timg.resize_nearest(torch.from_numpy(x), dst), jimg.resize_nearest(jnp.asarray(x), dst))


@pytest.mark.parametrize("src,dst", [((8, 8), (4, 4)), ((3, 5), (8, 6)), ((16, 16), (16, 16))])
def test_resize_bilinear_align_corners(src, dst):
    x = RNG.normal(size=(2, *src, 7)).astype(np.float32)
    _close(timg.resize_bilinear_align_corners(torch.from_numpy(x), dst),
           jimg.resize_bilinear_align_corners(jnp.asarray(x), dst), atol=1e-5)


def test_rgb_to_yuv420():
    """Same planes up to a rounding flip at exact .5 ties (fp32 order)."""
    x = RNG.uniform(size=(2, 8, 6, 3)).astype(np.float32)
    for ours, ref in zip(torch_yuv(torch.from_numpy(x)), jax_yuv(jnp.asarray(x))):
        assert ours.dtype == torch.uint8
        assert np.abs(ours.numpy().astype(int) - np.asarray(ref).astype(int)).max() <= 1
