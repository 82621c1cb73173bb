"""The VQGAN family of the PyTorch port against the JAX package (CPU,
fp32): nn/misc.py, the rest of models/vqgan.py (VectorQuantizer,
GumbelQuantizer, AttnBlock2D, VQAutoEncoder with both quantizers),
models/rqvae.py and models/codeformer.py.

Same seeded numpy weights (loaded strictly through flax_to_state_dict) and
inputs on both sides.  Tolerances: features within `close`'s default
(atol = rtol = 1e-4), codes and indices equal, losses within 5e-6
relative (an fp32 mean's summation order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu.models.codeformer as jcf
import pgtformer_tpu.models.rqvae as jrq
import pgtformer_tpu.models.vqgan as jvq
import pgtformer_tpu.nn.misc as jmisc
import pgtformer_tpu_torch.config as tcfg
import pgtformer_tpu_torch.models.codeformer as tcf
import pgtformer_tpu_torch.models.rqvae as trq
import pgtformer_tpu_torch.models.vqgan as tvq
import pgtformer_tpu_torch.nn.misc as tmisc
from tests.test_torch_common import (close, japply, one_torch_thread,  # noqa: F401
                                     random_variables, t, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOSS_RTOL = 5e-6


def _loss(ours, ref):
    np.testing.assert_allclose(float(ours.detach() if isinstance(ours, torch.Tensor) else ours),
                               float(ref), rtol=LOSS_RTOL, atol=0)


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


# -- nn/misc.py ----------------------------------------------------------------

MISC = {
    "ResidualBlockNoBN": (lambda: jmisc.ResidualBlockNoBN(nf=16),
                          lambda: tmisc.ResidualBlockNoBN(16), (2, 8, 8, 16)),
    "InputProj": (lambda: jmisc.InputProj(embed_dim=16),
                  lambda: tmisc.InputProj(3, 16), (1, 2, 8, 8, 3)),
    "InputProj+norm,stride": (lambda: jmisc.InputProj(embed_dim=16, stride=2, use_norm=True),
                              lambda: tmisc.InputProj(3, 16, stride=2, use_norm=True),
                              (1, 2, 8, 8, 3)),
    "SResBlock": (lambda: jmisc.SResBlock(num_res_blocks=2, out_channels=64),
                  lambda: tmisc.SResBlock(32, 2, 64), (1, 2, 8, 8, 32)),
    "StridedDownsample": (lambda: jmisc.StridedDownsample(24),
                          lambda: tmisc.StridedDownsample(16, 24), (1, 2, 8, 8, 16)),
    "TransposedUpsample": (lambda: jmisc.TransposedUpsample(24),
                           lambda: tmisc.TransposedUpsample(16, 24), (1, 2, 5, 7, 16)),
}


@pytest.mark.parametrize("name", list(MISC))
def test_misc_blocks(name):
    jfn, tfn, shape = MISC[name]
    x = _rand(1, shape)
    jm = jfn()
    v = random_variables(jm, jnp.asarray(x), seed=2)
    ours = to_port(tfn(), v)(t(x))
    close(ours, japply(jm, v, x))


# -- models/vqgan.py -------------------------------------------------------------

def test_vector_quantizer():
    z = _rand(3, (2, 4, 4, 16))
    jm = jvq.VectorQuantizer(32, 16, beta=0.3)
    v = random_variables(jm, jnp.asarray(z), seed=3)
    ref_q, ref_loss, ref_st = japply(jm, v, z)
    q, loss, st = to_port(tvq.VectorQuantizer(32, 16, beta=0.3), v)(t(z))
    close(q, ref_q)
    _loss(loss, ref_loss)
    np.testing.assert_array_equal(st["min_encoding_indices"].numpy(),
                                  np.asarray(ref_st["min_encoding_indices"]))
    assert len(np.unique(np.asarray(ref_st["min_encoding_indices"]))) > 4
    close(st["min_encoding_scores"], ref_st["min_encoding_scores"])
    for k in ("perplexity", "mean_distance"):
        _loss(st[k], ref_st[k])
    idx = np.random.default_rng(4).integers(0, 32, (2, 3, 3))
    feat = to_port(tvq.VectorQuantizer(32, 16), v).get_codebook_feat(torch.from_numpy(idx),
                                                                      (2, 3, 3, 16))
    ref = jvq.VectorQuantizer(32, 16).apply(v, jnp.asarray(idx), (2, 3, 3, 16),
                                            method="get_codebook_feat")
    close(feat, ref, atol=0, rtol=0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("straight_through", [False, True])
def test_gumbel_quantizer(monkeypatch, train, straight_through):
    """The same seeded noise on both sides: jax.random.gumbel and the port's
    gumbel_noise both return it."""
    z = _rand(5, (2, 4, 4, 16))
    noise = np.random.default_rng(6).gumbel(size=(2, 4, 4, 32)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda rng, shape, dtype: jnp.asarray(noise))
    monkeypatch.setattr(tvq, "gumbel_noise", lambda shape, generator, device: t(noise))
    kw = dict(straight_through=straight_through, kl_weight=5e-3, temp_init=0.7)
    jm = jvq.GumbelQuantizer(32, 8, 16, **kw)
    key = jax.random.PRNGKey(0)
    v = random_variables(jm, jnp.asarray(z), seed=7)
    ref_q, ref_diff, ref_st = japply(jm, v, z, train=train, rngs={"gumbel": key})
    port = to_port(tvq.GumbelQuantizer(32, 8, 16, **kw), v)
    q, diff, st = port(t(z), train=train, generator=torch.Generator().manual_seed(0))
    close(q, ref_q)
    _loss(diff, ref_diff)
    np.testing.assert_array_equal(st["min_encoding_indices"].numpy(),
                                  np.asarray(ref_st["min_encoding_indices"]))


def test_gumbel_noise_needs_a_generator():
    g = torch.Generator().manual_seed(1)
    a = tvq.gumbel_noise((64, 32), g, torch.device("cpu"))
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    assert abs(a.mean().item() - 0.5772) < 0.05           # Euler-Mascheroni
    with pytest.raises(ValueError, match="generator"):
        tvq.gumbel_noise((2,), None, torch.device("cpu"))


def test_attn_block_2d():
    x = _rand(8, (2, 4, 6, 32))
    jm = jvq.AttnBlock2D()
    v = random_variables(jm, jnp.asarray(x), seed=8)
    close(to_port(tvq.AttnBlock2D(32), v)(t(x)), japply(jm, v, x))


VQAE_KW = dict(img_size=32, nf=32, ch_mult=(1, 2), res_blocks=1, attn_resolutions=(16,),
               codebook_size=64, emb_dim=32, last_silu=True)


@pytest.mark.parametrize("quantizer", ["nearest", "gumbel"])
def test_vqautoencoder(monkeypatch, quantizer):
    x = _rand(9, (2, 32, 32, 3))
    key = jax.random.PRNGKey(1)
    if quantizer == "gumbel":
        noise = np.random.default_rng(10).gumbel(size=(2, 16, 16, 64)).astype(np.float32)
        monkeypatch.setattr(jax.random, "gumbel", lambda rng, shape, dtype: jnp.asarray(noise))
        monkeypatch.setattr(tvq, "gumbel_noise", lambda shape, generator, device: t(noise))
    jm = jvq.VQAutoEncoder(quantizer=quantizer, **VQAE_KW)
    v = random_variables(jm, jnp.asarray(x), seed=11)
    ref_out, ref_loss, ref_st = japply(jm, v, x, rngs={"gumbel": key})
    port = to_port(tvq.VQAutoEncoder(quantizer=quantizer, **VQAE_KW), v)
    g = torch.Generator().manual_seed(0)
    out, loss, st = port(t(x), generator=g)
    np.testing.assert_array_equal(st["min_encoding_indices"].numpy(),
                                  np.asarray(ref_st["min_encoding_indices"]))
    close(out, ref_out)
    _loss(loss, ref_loss)
    quant, _, _ = port(t(x), code_only=True, generator=g)
    assert quant.shape == (2, 16, 16, 32)


# -- models/rqvae.py -------------------------------------------------------------

_DD = dict(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_resolutions=(16,))
_VQ = dict(embed_dim=32, n_embed=64, latent_shape=(16, 16, 32), code_shape=(16, 16, 1),
           restart_unused_codes=False, decay=0.9)


def rq_configs():
    """(JAX config, port config) of the small 2-D geometry (32x32 frames,
    16x16 latents, attention at 16; no codebook restarts, so the EMA step
    draws nothing at random)."""
    return (jcfg.VQVAEConfig(ddconfig=jcfg.DDConfig(**_DD), **_VQ),
            tcfg.VQVAEConfig(ddconfig=tcfg.DDConfig(**_DD), **_VQ))


@pytest.fixture(scope="module")
def rqvae():
    jc, tc = rq_configs()
    x = _rand(12, (2, 32, 32, 3))
    jm = jrq.RQVAE(jc)
    v = random_variables(jm, jnp.asarray(x), seed=13)
    return jm, v, to_port(trq.RQVAE(tc), v), x


def test_rqvae_forward_and_code_path(rqvae):
    jm, v, port, x = rqvae
    ref_out, ref_loss, ref_codes = japply(jm, v, x)
    out, loss, codes = port(t(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert len(np.unique(np.asarray(ref_codes))) > 8
    close(out, ref_out)
    _loss(loss, ref_loss)
    np.testing.assert_array_equal(port.get_codes(t(x)).numpy(), np.asarray(ref_codes))
    close(port.decode_code(codes), japply(jm, v, ref_codes, method="decode_code"))
    close(port.encode(t(x)), japply(jm, v, x, method="encode"))
    z_q, _, _ = port(t(x), code_only=True)
    close(port.decode(z_q), out.detach(), atol=0, rtol=0)
    assert port.get_last_layer() is port.decoder.conv_out.weight
    assert ("decoder", "conv_out", "kernel") == jm.get_last_layer_path()


def test_rqvae_train_step_updates_the_codebook_like_jax(rqvae):
    """train=True: the EMA codebook step (no restarts) leaves the same
    weight, cluster_size_ema and embed_ema as JAX's mutable `codebook`."""
    jm, v, port, x = rqvae
    (ref_out, _, ref_codes), new = japply(jm, v, x, train=True, mutable=["codebook"])
    before = {k: b.clone() for k, b in port.quantizer.state_dict().items()}
    out, _, codes = port(t(x), train=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    close(out, ref_out)
    book = new["codebook"]["quantizer"]
    sd = port.quantizer.state_dict()
    for leaf, key in (("weight", "weight"), ("cluster_size_ema", "cluster_size_ema"),
                      ("embed_ema", "embed_ema")):
        ref = np.asarray(book[f"codebooks_0_{leaf}"])
        got = sd[f"codebooks.0.{key}"]
        assert not torch.equal(got, before[f"codebooks.0.{key}"]), key
        close(got, ref, atol=1e-5, rtol=1e-5)
    port.quantizer.load_state_dict(before)       # the fixture's model, as it was


# -- models/codeformer.py ---------------------------------------------------------

class _TablesFor64:
    """The three class tables relabelled for a 64x64 image through
    ch_mult (1, 2, 2, 4), one resblock a level, attention at 8: the encoder
    taps after each level's resblock, the generator fuses before each
    upsample."""
    FUSE_ENCODER_BLOCK = {"64": 1, "32": 3, "16": 5, "8": 8}
    FUSE_GENERATOR_BLOCK = {"8": 5, "16": 7, "32": 9, "64": 11}
    CHANNELS = {"8": 128, "16": 64, "32": 64, "64": 32}


class JaxSmallCodeFormer(_TablesFor64, jcf.CodeFormer):
    pass


class SmallCodeFormer(_TablesFor64, tcf.CodeFormer):
    pass


CF_KW = dict(dim_embd=32, n_head=4, n_layers=2, codebook_size=64, latent_size=64,
             connect_list=("16", "32", "64"), img_size=64, nf=32, ch_mult=(1, 2, 2, 4),
             res_blocks=1, attn_resolutions=(8,), emb_dim=32)


@pytest.fixture(scope="module")
def codeformer():
    x = _rand(14, (2, 64, 64, 3), 0.0, 1.0)
    jm = JaxSmallCodeFormer(**CF_KW)
    v = random_variables(jm, jnp.asarray(x), seed=15, w=1.0)
    return jm, v, to_port(SmallCodeFormer(**CF_KW), v), x


@pytest.mark.parametrize("w,adain", [(0.0, False), (0.7, True)])
def test_codeformer(codeformer, w, adain):
    jm, v, port, x = codeformer
    ref_out, ref_logits, ref_lq = japply(jm, v, x, w=w, adain=adain)
    out, logits, lq = port(t(x), w=w, adain=adain)
    close(lq, ref_lq)
    close(logits, ref_logits)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(ref_logits, -1)))
    close(out, ref_out)
    if w == 0.0:
        # the port's code_only returns the same logits and features
        c_logits, c_lq = port(t(x), code_only=True)
        close(c_logits, logits.detach(), atol=0, rtol=0)
        close(c_lq, lq.detach(), atol=0, rtol=0)
    else:
        # the fuse hooks ran: w = 0 decodes otherwise
        assert not torch.allclose(out, port(t(x), w=0.0, adain=adain)[0], atol=1e-3)


def test_codeformer_class_tables_are_the_jax_ones():
    for name in ("FUSE_ENCODER_BLOCK", "FUSE_GENERATOR_BLOCK", "CHANNELS"):
        assert getattr(tcf.CodeFormer, name) == getattr(jcf.CodeFormer, name)


def test_codeformer_position_emb_stays_fp32(codeformer):
    _, _, port, _ = codeformer
    m = SmallCodeFormer(**CF_KW).to(torch.bfloat16)
    assert m.position_emb.dtype == torch.float32
    assert m.feat_emb.weight.dtype == torch.bfloat16
    assert m.quantize.embedding.weight.dtype == torch.float32
    assert dict(port.named_parameters())["position_emb"].shape == (64, 32)
