"""The Video-Swin layer, TDRQVAE, the cross-frame DecoderLayer and
CodeFormer's cross-attention layer and sine embedding of the PyTorch port
against the JAX package (CPU, fp32).

Same seeded numpy weights (loaded strictly through flax_to_state_dict) and
inputs on both sides.  Tolerances: features within `close`'s default
(atol = rtol = 1e-4), codes equal, losses within 5e-6 relative.

The JAX package builds its 3-D masks with jnp inside ``compute_mask_3d``,
which cannot run under a trace; :func:`prime_masks` fills its cache
eagerly first for every geometry a test traces.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu.models.tdrqvae as jtd
import pgtformer_tpu.nn.blocks as jblocks
import pgtformer_tpu.nn.swin3d as js
import pgtformer_tpu.nn.transformer as jtr
import pgtformer_tpu_torch.config as tcfg
import pgtformer_tpu_torch.models.tdrqvae as ttd
import pgtformer_tpu_torch.nn.blocks as tblocks
import pgtformer_tpu_torch.nn.swin3d as ts
import pgtformer_tpu_torch.nn.transformer as ttr
from tests.test_torch_common import (close, japply, one_torch_thread,  # noqa: F401
                                     random_variables, t, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def prime_masks(size, window):
    """Fill the JAX mask cache for the shifted block of a stack on an input
    of `size` (D, H, W): window and shift clamped where an axis is no
    longer than the window, each axis padded up to its window."""
    win, shift = list(window), [w // 2 for w in window]
    for i, s in enumerate(size):
        if s <= win[i]:
            win[i], shift[i] = s, 0
    if any(shift):
        padded = [s + (-s) % w for s, w in zip(size, win)]
        js.compute_mask_3d(*padded, tuple(win), tuple(shift))


def test_numpy_constants_match():
    for win in ((2, 4, 4), (3, 5, 5), (1, 7, 7)):
        np.testing.assert_array_equal(ts.relative_position_index_3d(win),
                                      js.relative_position_index_3d(win))
    for geo in ((4, 8, 8, (2, 4, 4), (1, 2, 2)), (3, 10, 10, (3, 5, 5), (0, 2, 2))):
        np.testing.assert_array_equal(ts.compute_mask_3d(*geo), js.compute_mask_3d(*geo))
    x = _rand(0, (2, 4, 8, 12, 5))
    w = ts.window_partition_3d(t(x), (2, 4, 4))
    close(w, js.window_partition_3d(jnp.asarray(x), (2, 4, 4)), atol=0, rtol=0)
    close(ts.window_reverse_3d(w, (2, 4, 4), 2, 4, 8, 12), x, atol=0, rtol=0)


# (D, H, W), window: an axis clamped to its window (D = 2), one padded
# (H = W = 6 under 4); H clamped (4) with D padded (3 under 2)
SWIN_CASES = {"clamp_d_pad_hw": ((2, 6, 6), (2, 4, 4)),
              "clamp_h_pad_d": ((3, 4, 8), (2, 4, 4)),
              "no_clamp": ((4, 8, 8), (2, 4, 4))}


@pytest.mark.parametrize("case", list(SWIN_CASES))
def test_basic_layer_3d(case):
    size, win = SWIN_CASES[case]
    prime_masks(size, win)
    x = _rand(1, (2, *size, 32))
    jm = js.BasicLayer3D(dim=32, depth=2, num_heads=4, window_size=win, downsample=True)
    v = random_variables(jm, jnp.asarray(x), seed=2)
    port = to_port(ts.BasicLayer3D(32, 2, 4, win, downsample=True, input_size=size), v)
    close(port(t(x)), japply(jm, v, x))


def test_swin_block_refuses_another_clamp():
    blk = ts.SwinTransformerBlock3D(16, 2, (2, 4, 4), (1, 2, 2), input_size=(4, 8, 8))
    with pytest.raises(NotImplementedError, match="input_size"):
        blk(torch.zeros(1, 1, 8, 8, 16))         # D = 1 clamps the window to 1


def test_patch_embed_and_trunk():
    """PatchEmbed3D pads every axis (5 x 10 x 10 under 2 x 4 x 4); the
    trunk's second stage clamps H and W."""
    x = _rand(3, (1, 5, 10, 10, 3))
    kw = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=(2, 2, 2))
    prime_masks((3, 3, 3), (2, 2, 2))
    prime_masks((3, 2, 2), (2, 2, 2))
    jm = js.SwinTransformer3D(**kw)
    v = random_variables(jm, jnp.asarray(x), seed=4)
    port = to_port(ts.SwinTransformer3D(**kw, input_size=(5, 10, 10)), v)
    close(port(t(x)), japply(jm, v, x))
    je = js.PatchEmbed3D(embed_dim=8)
    ve = random_variables(je, jnp.asarray(x), seed=5)
    close(to_port(ts.PatchEmbed3D(embed_dim=8), ve)(t(x)), japply(je, ve, x))


# -- models/tdrqvae.py -------------------------------------------------------------

_DD = dict(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_resolutions=(16,), stages_atten=2, window_size=(2, 4, 4), num_head=4)
_VQ = dict(embed_dim=32, n_embed=64, latent_shape=(16, 16, 32), code_shape=(16, 16, 1))


@pytest.fixture(scope="module")
def tdrqvae():
    jc = jcfg.VQVAEConfig(ddconfig=jcfg.DDConfig(**_DD), **_VQ)
    tc = tcfg.VQVAEConfig(ddconfig=tcfg.DDConfig(**_DD), **_VQ)
    prime_masks((3, 16, 16), (2, 4, 4))
    x = _rand(6, (1, 3, 32, 32, 3))
    jm = jtd.TDRQVAE(jc)
    v = random_variables(jm, jnp.asarray(x), seed=7)
    return jm, v, to_port(ttd.TDRQVAE(tc), v), x


def test_tdrqvae(tdrqvae):
    jm, v, port, x = tdrqvae
    ref_out, ref_loss, ref_codes = japply(jm, v, x)
    out, loss, codes = port(t(x))
    assert codes.shape == (1, 3, 16, 16, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert len(np.unique(np.asarray(ref_codes))) > 8
    close(out, ref_out)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=5e-6, atol=0)
    np.testing.assert_array_equal(port.get_codes(t(x)).numpy(),
                                  np.asarray(japply(jm, v, x, method="get_codes")))
    z_q, _, _ = port(t(x), code_only=True)
    ref_zq, _, _ = japply(jm, v, x, code_only=True)
    close(z_q, ref_zq)


# -- nn/blocks.py: the cross-frame DecoderLayer -----------------------------------

@pytest.mark.parametrize("t_kv", [3, 2])
def test_decoder_layer(t_kv):
    """tests/test_decoder_layer.py's geometry (dim 32, 4 heads, T 3, 8x8,
    window 4, both shifts), keys and values of 3 frames and of 2."""
    x = _rand(8, (2, 3, 8, 8, 32))
    kv = _rand(9, (2, t_kv, 8, 8, 32))
    jm = jblocks.DecoderLayer(dim=32, depth=2, num_heads=4, num_frames=3, window_size=(4, 4),
                              mlp_ratio=1.0)
    v = random_variables(jm, jnp.asarray(x), jnp.asarray(kv), seed=10)
    port = to_port(tblocks.DecoderLayer(32, 2, 4, 3, (4, 4), mlp_ratio=1.0), v)
    assert "blocks.0.attn.q.weight" in port.state_dict()      # the exporter's name
    assert "blocks.1.attn2.relative_position_bias_table" in port.state_dict()
    close(port(t(x), t(kv)), japply(jm, v, x, kv))


# -- nn/transformer.py ----------------------------------------------------------------

@pytest.mark.parametrize("with_pos", [False, True])
def test_transformer_ca_layer(with_pos):
    a, b = _rand(11, (2, 24, 32)), _rand(12, (2, 24, 32))
    pos = _rand(13, (1, 24, 32)) if with_pos else None
    jm = jtr.TransformerCALayer(embed_dim=32, nhead=4, dim_mlp=64)
    v = random_variables(jm, jnp.asarray(a), jnp.asarray(b), seed=14)
    port = to_port(ttr.TransformerCALayer(32, 4, 64), v)
    ref = japply(jm, v, a, b, w=0.6, query_pos=None if pos is None else jnp.asarray(pos))
    close(port(t(a), t(b), w=0.6, query_pos=None if pos is None else t(pos)), ref)


@pytest.mark.parametrize("normalize", [False, True])
def test_position_embedding_sine(normalize):
    x = np.zeros((2, 6, 5, 3), np.float32)
    ref = jtr.PositionEmbeddingSine(num_pos_feats=16, normalize=normalize).apply(
        {}, jnp.asarray(x))
    ours = ttr.PositionEmbeddingSine(16, normalize=normalize)(t(x))
    assert ours.shape == (2, 6, 5, 32)
    close(ours, ref, atol=0, rtol=0)
