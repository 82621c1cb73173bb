"""nn blocks and the two kernels' XLA forms of the PyTorch port against the
JAX package's XLA path (CPU, fp32, atol/rtol 1e-4).  The kernels' plain
versions equal the XLA forms under bf16; under fp32 they take the kernels'
fp32 form (bf16 inside), which tests/test_torch_fp32_plans.py holds to the
JAX kernels."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.nn.blocks as jb
import pgtformer_tpu.nn.transformer as jt
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.nn.transformer as tt
from pgtformer_tpu.ops.flash_attn import _dense_mha_ref
from pgtformer_tpu.ops.pallas_attn import sw_block_5d_xla
from pgtformer_tpu.ops.window import relative_position_index, shifted_window_mask
from pgtformer_tpu.ops.flash_attn import dense_mha as jax_dense_mha
from pgtformer_tpu_torch.ops.dense_mha import (
    dense_mha, dense_mha_plain, dense_mha_plain_bnhd, dense_mha_ref)
from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_plain, sw_block_xla
from tests.test_torch_common import close, japply, random_variables, t, to_port

RNG = np.random.default_rng(0)


def _pair(jmod, tmod, x, seed=0, **kw):
    v = random_variables(jmod, jnp.asarray(x), seed=seed, **kw)
    return v, to_port(tmod, v)


@pytest.mark.parametrize("cin,cout", [(32, 32), (32, 64)])
def test_resnet_block(cin, cout):
    x = RNG.normal(size=(2, 3, 8, 8, cin)).astype(np.float32)
    v, mod = _pair(jb.ResnetBlock(out_channels=cout), tb.ResnetBlock(cin, cout), x)
    with torch.no_grad():
        close(mod(t(x)), japply(jb.ResnetBlock(out_channels=cout), v, x))


def test_downsample_upsample():
    x = RNG.normal(size=(2, 3, 8, 8, 32)).astype(np.float32)
    v, mod = _pair(jb.Downsample(), tb.Downsample(32), x)
    with torch.no_grad():
        y = mod(t(x))
    assert y.shape == (2, 3, 4, 4, 32)
    close(y, japply(jb.Downsample(), v, x))
    v, mod = _pair(jb.Upsample(), tb.Upsample(32), x)
    with torch.no_grad():
        y = mod(t(x))
    assert y.shape == (2, 3, 16, 16, 32)
    close(y, japply(jb.Upsample(), v, x))


@pytest.mark.parametrize("shift", [(0, 0), (2, 2)])
def test_sw_transformer_block(shift):
    x = RNG.normal(size=(2, 3, 8, 8, 64)).astype(np.float32)
    kw = dict(dim=64, num_heads=4, num_frames=3, window_size=(4, 4), shift_size=shift,
              mlp_ratio=1.0)
    jmod = jb.SWTransformerBlock(**kw)
    v, mod = _pair(jmod, tb.SWTransformerBlock(64, 4, 3, (4, 4), shift, 1.0), x)
    with torch.no_grad():
        close(mod(t(x)), japply(jmod, v, x))


@pytest.mark.parametrize("C,hw", [(64, (8, 8)), (128, (8, 12)), (64, (6, 6))])
def test_encoder_layer(C, hw):
    """Depth 2: the unshifted and the half-window-shifted block.  (6, 6)
    does not divide by the window: the padded module path."""
    x = RNG.normal(size=(2, 3, *hw, C)).astype(np.float32)
    jmod = jb.EncoderLayer(dim=C, depth=2, num_heads=4, num_frames=3, window_size=(4, 4),
                           mlp_ratio=1.0)
    v, mod = _pair(jmod, tb.EncoderLayer(C, 2, 4, 3, (4, 4), mlp_ratio=1.0), x)
    with torch.no_grad():
        close(mod(t(x)), japply(jmod, v, x))


@pytest.mark.parametrize("shift", [(0, 0), (2, 2)])
def test_sw_block_plain_matches_xla(shift):
    """The XLA form against the JAX package's sw_block_5d_xla, the oracle of
    the TPU kernel (fp32); the kernel's plain version (and the CPU path of
    the wrapper) equals it under bf16."""
    C, heads, T = 64, 4, 3
    x = RNG.normal(size=(2, T, 8, 12, C)).astype(np.float32)
    jmod = jb.SWTransformerBlock(dim=C, num_heads=heads, num_frames=T, window_size=(4, 4),
                                 mlp_ratio=1.0)
    v, mod = _pair(jmod, tb.SWTransformerBlock(C, heads, T, (4, 4), (0, 0), 1.0), x)
    p = v["params"]
    idx = relative_position_index(T, T, (4, 4))
    rb = p["attn1"]["relative_position_bias_table"][idx.reshape(-1)].reshape(48, 48, heads)
    rb = np.asarray(rb).transpose(2, 0, 1)
    mask = shifted_window_mask(T, 8, 12, (4, 4), shift) if any(shift) else None
    ref = sw_block_5d_xla(jnp.asarray(x), p, jnp.asarray(rb), mask, heads, (4, 4), shift)
    w = mod.kernel_weights(torch.device("cpu"))
    close(w.rel_bias, rb, atol=0, rtol=0)
    with torch.no_grad():
        close(sw_block_xla(t(x), w, shift), ref)
        xb = t(x).to(torch.bfloat16)
        assert torch.equal(sw_block_plain(xb, w, shift), sw_block_xla(xb, w, shift))
        assert torch.equal(sw_block(xb, w, shift), sw_block_xla(xb, w, shift))


def test_dense_mha_plain_matches_ref():
    """dense_mha_ref against the JAX package's _dense_mha_ref (fp32); the
    plain version equals it under bf16."""
    q, k, v = (RNG.normal(size=(2, 4, 40, 16)).astype(np.float32) for _ in range(3))
    ref = _dense_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25)
    close(dense_mha_ref(t(q), t(k), t(v), 0.25), ref, atol=1e-5)
    qb, kb, vb = (t(a).to(torch.bfloat16) for a in (q, k, v))
    assert torch.equal(dense_mha_plain(qb, kb, vb, 0.25), dense_mha_ref(qb, kb, vb, 0.25))


def test_dense_mha_wrapper_reads_packed_projections():
    """CPU path of the wrapper on strided views of packed [B, N, 2C] / [B, N, C]
    (fp32, the kernel's fp32 form): equal to the plain version on contiguous
    copies, and within the kernel rule (2e-2 * max|ref|) of the JAX kernel
    on the same packed views (interpret mode)."""
    B, N, H, D = 2, 24, 4, 16
    C = H * D
    qk = t(RNG.normal(size=(B, N, 2 * C)).astype(np.float32))
    v = t(RNG.normal(size=(B, N, C)).astype(np.float32))
    split = lambda a: a.reshape(B, N, H, D)
    views = (split(qk[..., :C]), split(qk[..., C:]), split(v))
    out = dense_mha(*views, scale=D ** -0.5, layout="bnhd")
    assert out.dtype == torch.float32
    assert torch.equal(out, dense_mha_plain_bnhd(*(a.contiguous() for a in views), D ** -0.5))
    jqk, jv = jnp.asarray(qk.numpy()), jnp.asarray(v.numpy())
    jsplit = lambda a: a.reshape(B, N, H, D)
    ref = np.asarray(jax_dense_mha(jsplit(jqk[..., :C]), jsplit(jqk[..., C:]), jsplit(jv),
                                   scale=D ** -0.5, layout="bnhd", interpret=True))
    err = np.abs(out.numpy() - ref).max()
    assert ref.dtype == np.float32 and err <= 2e-2 * np.abs(ref).max(), err


@pytest.mark.parametrize("with_pos", [True, False])
def test_transformer_sa_layer(with_pos):
    x = RNG.normal(size=(2, 48, 64)).astype(np.float32)
    pos = RNG.normal(size=(2, 48, 64)).astype(np.float32) if with_pos else None
    jmod = jt.TransformerSALayer(embed_dim=64, nhead=4, dim_mlp=128)
    kw = {"query_pos": jnp.asarray(pos)} if with_pos else {}
    v, mod = _pair(jmod, tt.TransformerSALayer(64, 4, 128), x, **kw)
    with torch.no_grad():
        ours = mod(t(x), query_pos=t(pos) if with_pos else None)
    close(ours, japply(jmod, v, x, *kw.values()))


def test_mhsa_separate_q_k():
    """q is not k: separate q and k projections."""
    q, k, vv = (RNG.normal(size=(2, 16, 64)).astype(np.float32) for _ in range(3))
    jmod = jt.MultiHeadSelfAttention(embed_dim=64, num_heads=4)
    v = random_variables(jmod, jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv), seed=1)
    mod = to_port(tt.MultiHeadSelfAttention(64, 4), v)
    with torch.no_grad():
        close(mod(t(q), t(k), t(vv)), japply(jmod, v, q, k, vv))
