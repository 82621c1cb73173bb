"""Models of the PyTorch port against the JAX package (CPU, fp32).

PGTFormer follows the JAX package's full-parity method: lq_feat and
logits, then the code agreement, then the decode with the JAX codes forced
through `restore_from_codes` (so a near-tie argmax flip cannot hide or
fake a decoder difference)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.models.parser as jparser
import pgtformer_tpu.models.pgtformer as jpgt
import pgtformer_tpu.models.quantizer as jquant
import pgtformer_tpu.models.vae as jvae
import pgtformer_tpu_torch.models.parser as tparser
import pgtformer_tpu_torch.models.pgtformer as tpgt
import pgtformer_tpu_torch.models.quantizer as tquant
import pgtformer_tpu_torch.models.vae as tvae
from tests.test_torch_common import (close, japply, random_variables, small_configs,  # noqa: F401
                                     small_pgt, t, to_port)

RNG = np.random.default_rng(0)


def test_bisenet():
    x = (RNG.normal(size=(2, 64, 64, 3)) * 0.5).astype(np.float32)
    jmod = jparser.BiSeNet(19, out_hw=(8, 8))
    v = random_variables(jmod, jnp.asarray(x), seed=2)
    mod = to_port(tparser.BiSeNet(19, (8, 8)), v)
    with torch.no_grad():
        out = mod(t(x))
    assert out.shape == (2, 8, 8, 57)
    close(out, japply(jmod, v, x))


@pytest.mark.parametrize("shared", [True, False])
def test_rq_embed_code(shared):
    """embed_code with 2x2 space-to-depth and depth 2; code n_embed is the
    zero padding row."""
    kw = dict(latent_shape=(8, 8, 16), code_shape=(4, 4, 2), n_embed=32)
    x = RNG.normal(size=(2, 8, 8, 16)).astype(np.float32)
    jmod = jquant.RQBottleneck(shared_codebook=shared, **kw)
    v = random_variables(jmod, jnp.asarray(x), seed=6)
    mod = to_port(tquant.RQBottleneck(kw["latent_shape"], kw["code_shape"], kw["n_embed"],
                                      shared_codebook=shared), v)
    codes = RNG.integers(0, 33, (2, 4, 4, 2))
    codes[0, 0, 0] = 32
    with torch.no_grad():
        out = mod.embed_code(torch.from_numpy(codes))
    assert out.shape == (2, 8, 8, 16)
    close(out, japply(jmod, v, codes, method="embed_code"), atol=1e-6, rtol=1e-6)
    close(mod.to_latent_shape(mod.to_code_shape(t(x))), x, atol=0, rtol=0)


@pytest.mark.parametrize("middle_only", [False, True])
def test_fuse_sft_block(middle_only):
    enc, dec = (RNG.normal(size=(2, 3, 8, 8, 64)).astype(np.float32) for _ in range(2))
    jmod = jpgt.FuseSftBlock(64, 64, t=3)
    v = random_variables(jmod, jnp.asarray(enc), jnp.asarray(dec), seed=3)
    mod = to_port(tpgt.FuseSftBlock(64, 64, t=3), v)
    with torch.no_grad():
        out = mod(t(enc), t(dec), w=0.7, middle_only=middle_only)
    assert out.shape == (2, 1 if middle_only else 3, 8, 8, 64)
    close(out, japply(jmod, v, enc, dec, w=0.7, middle_only=middle_only))


def test_encoder3d_stages():
    dd = small_configs()[1].vqvae.ddconfig
    x = RNG.uniform(size=(2, 3, 32, 32, 3)).astype(np.float32)
    jmod = jvae.Encoder3D(small_configs()[0].vqvae.ddconfig)
    v = random_variables(jmod, jnp.asarray(x), seed=4)
    mod = to_port(tvae.Encoder3D(dd, num_frames=3), v)
    with torch.no_grad():
        h, feats = mod(t(x), stage="trunk")
        jh, jfeats = japply(jmod, v, x, stage="trunk")
        close(h, jh)
        for a, b in zip(feats, jfeats):
            close(a, b)
        z, head = mod(h, return_multi_res_feats=True, stage="head")
        jz, jhead = japply(jmod, v, jh, return_multi_res_feats=True, stage="head")
        close(z, jz)
        for a, b in zip(head, jhead):
            close(a, b)
        close(mod(t(x)), japply(jmod, v, x))


def _fuse(xp, middle_only=False):
    """A frame-mixing stand-in for the Fuse-SFT skips (jnp or torch)."""
    def fn(resolution, h, middle_only=False):
        h = h + 0.1 * h.mean(**({"axis": 1, "keepdims": True} if xp is jnp
                                  else {"dim": 1, "keepdim": True}))
        return h[:, 1:2] if middle_only else h
    return fn


@pytest.mark.parametrize("middle_only", [False, True])
def test_decoder3d(middle_only):
    jdd, dd = small_configs()[0].vqvae.ddconfig, small_configs()[1].vqvae.ddconfig
    z = RNG.normal(size=(6, 16, 16, 32)).astype(np.float32)
    jmod = jvae.Decoder3D(jdd, num_frames=3)
    v = random_variables(jmod, jnp.asarray(z), seed=5)
    mod = to_port(tvae.Decoder3D(dd, num_frames=3), v)
    with torch.no_grad():
        out = mod(t(z), fuse_fn=_fuse(torch), middle_only=middle_only,
                  fuse_resolutions=(16, 32))
    ref = japply(jmod, v, z, fuse_fn=_fuse(jnp), middle_only=middle_only,
                 fuse_resolutions=(16, 32))
    assert out.shape == ((2 if middle_only else 6), 32, 32, 3)
    close(out, ref)


def test_pgtformer_full_parity(small_pgt):
    jm, v, model, x = small_pgt
    out_j, logits_j, lq_j = japply(jm, v, x, w=1.0)
    with torch.no_grad():
        out, logits, lq = model(t(x), w=1.0)
    close(lq, lq_j, atol=1e-4, rtol=1e-4)
    close(logits, logits_j, atol=1e-4, rtol=1e-4)
    codes_j = np.array(jnp.argmax(logits_j, axis=-1))
    agreement = (logits.argmax(-1).numpy() == codes_j).mean()
    assert agreement >= 0.99, agreement
    with torch.no_grad():
        forced = model.restore_from_codes(t(x), torch.from_numpy(codes_j), w=1.0)
    ref = japply(jm, v, x, codes_j, w=1.0, method=jpgt.PGTFormer.restore_from_codes)
    close(forced, ref, atol=1e-4, rtol=1e-4)
    if agreement == 1.0:       # holds at this seed: the whole forward agrees
        close(out, out_j, atol=1e-4, rtol=1e-4)


def test_pgtformer_serving_split(small_pgt):
    """encode_frames + restore_windows(middle_only=True), the two halves of
    the serving step."""
    jm, v, model, x = small_pgt
    frames = x.reshape(6, 32, 32, 3)
    pos_j, trunk_j, skips_j = japply(jm, v, frames, method="encode_frames")
    with torch.no_grad():
        pos, trunk, skips = model.encode_frames(t(frames))
    close(pos, pos_j)
    close(trunk, trunk_j)
    for a, b in zip(skips, skips_j):
        close(a, b)
    win = lambda a: a.reshape(2, 3, *a.shape[1:])
    out_j, _, _ = japply(jm, v, win(pos_j), win(trunk_j), tuple(win(s) for s in skips_j),
                         w=1.0, middle_only=True, method="restore_windows")
    with torch.no_grad():
        out, _, _ = model.restore_windows(win(pos), win(trunk), tuple(win(s) for s in skips),
                                          w=1.0, middle_only=True)
    assert out.shape == (2, 32, 32, 3)
    close(out, out_j, atol=1e-4, rtol=1e-4)
