"""The autoencoder / code path of the PyTorch port against the JAX package
(CPU, fp32): TDCRQVAE3 and PGTFormer.get_codes / decode_code.

Same seeded numpy weights (loaded strictly through flax_to_state_dict) and
inputs on both sides.  Tolerances: outputs 2e-5 abs (fp32 conv and matmul
summation order through ~20 layers), codes equal, losses 1e-5 relative,
soft codes of the whole model 1e-5 abs + 1e-4 relative.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.models.pgtformer as jpgt
import pgtformer_tpu.models.vae as jvae
import pgtformer_tpu_torch.models.vae as tvae
from pgtformer_tpu.convert.torch_port import export_torch_state_dict
from pgtformer_tpu_torch.convert import flax_to_state_dict
from tests.test_torch_common import (close, japply, random_variables, small_configs,  # noqa: F401
                                     small_pgt, t, to_port)

TOL = dict(atol=2e-5, rtol=0)
# depth-1 shared codebook (the deployed shape), and depth 2 with its own
# codebook per depth and a 2x2 space-to-depth code grid
VQ_VARIANTS = {
    "depth1": {},
    "depth2": dict(code_shape=(8, 8, 2), shared_codebook=False, loss_type="l1"),
}


def _vae(variant: str):
    jc, tc = small_configs()
    jv = dataclasses.replace(jc.vqvae, **VQ_VARIANTS[variant])
    tv = dataclasses.replace(tc.vqvae, **VQ_VARIANTS[variant])
    x = np.random.default_rng(3).uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jm = jvae.TDCRQVAE3(jv)
    v = random_variables(jm, jnp.asarray(x), seed=8)
    return jm, v, to_port(tvae.TDCRQVAE3(tv), v), x


@pytest.fixture(scope="module", params=list(VQ_VARIANTS))
def vae(request):
    return _vae(request.param)


def test_tdcrqvae3_state_dict_is_the_exported_one(vae):
    """The strict load worked (the fixture did it); the key set and values
    are exactly what the JAX package's exporter emits."""
    _, v, model, _ = vae
    ours, ref = flax_to_state_dict(v), export_torch_state_dict(v)
    assert ours.keys() == ref.keys() == model.state_dict().keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    assert "quantizer.codebooks.0.embed_ema" in ours and "post_quant_conv.weight" in ours


def test_tdcrqvae3_forward(vae):
    jm, v, model, x = vae
    out_j, loss_j, codes_j = japply(jm, v, x)
    with torch.no_grad():
        out, loss, codes = model(t(x))
    assert out.shape == (6, 32, 32, 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    close(out, out_j, **TOL)
    close(loss, loss_j, atol=0, rtol=1e-5)
    zq_j, _, _ = japply(jm, v, x, code_only=True)
    with torch.no_grad():
        zq, loss2, codes2 = model(t(x), code_only=True)
    close(zq, zq_j, **TOL)
    assert torch.equal(codes2, codes) and torch.equal(loss2, loss)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="generator"):      # restarts need one
        model(t(x), train=True)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_tdcrqvae3_encode(vae):
    jm, v, model, x = vae
    z_j, feats_j = japply(jm, v, x, return_multi_res_feats=True, method="encode")
    with torch.no_grad():
        z, feats = model.encode(t(x), return_multi_res_feats=True)
        close(model.encode(t(x)), z_j, **TOL)
    close(z, z_j, **TOL)
    assert len(feats) == len(feats_j)
    for a, b in zip(feats, feats_j):
        close(a, b, **TOL)


def test_tdcrqvae3_code_path(vae):
    jm, v, model, x = vae
    codes_j = np.array(japply(jm, v, x, method="get_codes"))
    with torch.no_grad():
        codes = model.get_codes(t(x))
        assert torch.equal(model.get_codesbt(t(x)), codes)
        assert torch.equal(model.get_codes_flat(t(x.reshape(6, 32, 32, 3))), codes)
        dec = model.decode_code(codes)
        full, _, _ = model(t(x))
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    np.testing.assert_array_equal(
        codes_j, np.asarray(japply(jm, v, x.reshape(6, 32, 32, 3), method="get_codes_flat")))
    close(dec, japply(jm, v, codes_j, method="decode_code"), **TOL)
    # x + (q - x) rounds in fp32, so decode_code(get_codes(x)) is close to,
    # not the same as, the forward's reconstruction
    close(dec, full, atol=1e-4, rtol=0)


def test_tdcrqvae3_partial_and_soft_codes(vae):
    jm, v, model, x = vae
    depth = model.cfg.code_shape[-1]
    codes_j = np.array(japply(jm, v, x, method="get_codes"))
    tc = torch.from_numpy(codes_j)
    with torch.no_grad():
        for kind in ("select", "add"):
            close(model.decode_partial_code(tc, depth - 1, kind),
                  japply(jm, v, codes_j, code_idx=depth - 1, decode_type=kind,
                         method="decode_partial_code"), **TOL)
        close(model.forward_partial_code(t(x), 0, "add"),
              japply(jm, v, x, code_idx=0, decode_type="add",
                     method="forward_partial_code"), **TOL)
        emb, _ = model.get_code_emb_with_depth(tc)
        close(emb, japply(jm, v, codes_j, method="get_code_emb_with_depth")[0],
              atol=1e-6, rtol=0)
        soft, codes = model.get_soft_codes(t(x), temp=0.5)
    soft_j, soft_codes_j = japply(jm, v, x, temp=0.5, method="get_soft_codes")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(soft_codes_j))
    # softmax(-dist / 0.5) of an encoder output that itself carries ~1e-5
    close(soft, soft_j, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("valid", [False, True])
def test_tdcrqvae3_compute_loss(vae, valid):
    jm, v, model, x = vae
    out_j, loss_j, codes_j = japply(jm, v, x)
    ref = jm.compute_loss(out_j.reshape(2, 3, 32, 32, 3), loss_j, codes_j,
                          jnp.asarray(x), valid=valid)
    with torch.no_grad():
        out, loss, codes = model(t(x))
        ours = model.compute_loss(out.reshape(2, 3, 32, 32, 3), loss, codes, t(x), valid=valid)
    for key in ("loss_total", "loss_recon", "loss_latent"):
        close(ours[key], ref[key], atol=0, rtol=1e-5)
    assert torch.equal(ours["codes"][0], codes)
    real, recon = tvae.TDCRQVAE3.get_recon_imgs(t(x), out)
    real_j, recon_j = jvae.TDCRQVAE3.get_recon_imgs(jnp.asarray(x), out_j)
    close(real, real_j, atol=1e-6, rtol=0)
    close(recon, recon_j, **TOL)
    assert recon.min() >= 0 and recon.max() <= 1


def test_tdcrqvae3_rejects_bad_config():
    _, tc = small_configs()
    with pytest.raises(ValueError):
        tvae.TDCRQVAE3(dataclasses.replace(tc.vqvae, bottleneck_type="vq"))
    with pytest.raises(ValueError):
        tvae.TDCRQVAE3(dataclasses.replace(tc.vqvae, loss_type="huber"))


def test_tdcrqvae3_seeded_init_is_deterministic():
    _, tc = small_configs()
    a = tvae.TDCRQVAE3(tc.vqvae, generator=torch.Generator().manual_seed(4))
    b = tvae.TDCRQVAE3(tc.vqvae, generator=torch.Generator().manual_seed(4))
    for (k, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), k
    assert a.quantizer.codebooks[0].weight[-1].abs().max() == 0


def test_pgtformer_code_path(small_pgt):
    """PGTFormer.encode / get_codes / decode_code: the teacher's code
    targets and their decode."""
    jm, v, model, x = small_pgt
    z_j = japply(jm, v, x, method=jpgt.PGTFormer.encode)
    codes_j = np.array(japply(jm, v, x, method=jpgt.PGTFormer.get_codes))
    with torch.no_grad():
        close(model.encode(t(x)), z_j, **TOL)
        codes = model.get_codes(t(x))
        dec = model.decode_code(torch.from_numpy(codes_j))
    assert codes.shape == (6, 16, 16, 1)
    np.testing.assert_array_equal(codes.numpy(), codes_j)
    close(dec, japply(jm, v, codes_j, method=jpgt.PGTFormer.decode_code), **TOL)
