"""Nearest-code lookup and the residual quantizer of the PyTorch port
against the JAX package (CPU, fp32).

On the CPU the port's wrappers run their plain versions.  The JAX side runs
its Pallas lookup kernel in interpret mode and its XLA path.  Tolerances:
codes must be equal; a row may differ only where its two smallest fp32
distances lie within 1e-5 relative of each other (the lookup drops the
per-row |x|^2 term and sums in another order than compute_distances), and
the test prints how many did.  Quantized latents 1e-6 abs, soft codes 1e-5
abs.  Commitment loss 5e-6 relative: it is an fp32 mean of up to 2048
squares, and XLA's own reduction order leaves it 1.1e-6 from the fp64
value at these seeds (the port's fp32 mean equals the fp64 value there).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.models.quantizer as jquant
import pgtformer_tpu_torch.models.quantizer as tquant
from pgtformer_tpu.ops.pallas_vq import nearest_code_pallas
from pgtformer_tpu_torch.ops.vq import nearest_code, nearest_code_plain
from tests.test_torch_common import close, japply, random_variables, t, to_port


def _assert_codes_equal_up_to_near_ties(ours, ref, x, codes, what):
    """Equal codes, except on rows whose top-2 distances are a near-tie."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    diff = np.nonzero(ours != ref)[0]
    print(f"{what}: {len(diff)} of {len(ref)} rows differ")
    d = ((x[diff, None, :].astype(np.float64) - codes[None].astype(np.float64)) ** 2).sum(-1)
    for row, a, b in zip(d, ours[diff], ref[diff]):
        assert abs(row[a] - row[b]) <= 1e-5 * row[b], (row[a], row[b])


@pytest.mark.parametrize("N", [2048, 100])
def test_nearest_code_plain_matches_jax(N):
    """N=2048 tiles the Pallas kernel; N=100 is ragged (its XLA fallback)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2048, 64)).astype(np.float32)[:N]
    codes = rng.normal(size=(256, 64)).astype(np.float32)
    ours = nearest_code_plain(t(x), t(codes))
    assert ours.dtype == torch.int64 and ours.shape == (N,)
    assert torch.equal(nearest_code(t(x), t(codes)), ours)       # CPU wrapper = plain
    pallas = nearest_code_pallas(jnp.asarray(x), jnp.asarray(codes), interpret=True)
    _assert_codes_equal_up_to_near_ties(ours, pallas, x, codes, "vs Pallas (interpret)")
    weight = np.concatenate([codes, np.zeros((1, 64), np.float32)])
    exact = jnp.argmin(jquant.compute_distances(jnp.asarray(weight), jnp.asarray(x)), -1)
    _assert_codes_equal_up_to_near_ties(ours, exact, x, codes, "vs argmin(compute_distances)")
    close(tquant.compute_distances(t(weight), t(x)),
          jquant.compute_distances(jnp.asarray(weight), jnp.asarray(x)), atol=1e-4, rtol=1e-5)
    assert torch.equal(tquant.find_nearest_embedding(t(weight), t(x)),
                       tquant.compute_distances(t(weight), t(x)).argmin(-1))


def test_nearest_code_exact_tie_takes_lower_index():
    rng = np.random.default_rng(12)
    codes = rng.normal(size=(128, 64)).astype(np.float32)
    codes[77] = codes[5]                       # two identical rows
    x = rng.normal(size=(128, 64)).astype(np.float32)
    x[:16] = codes[5] + 0.01 * rng.normal(size=(16, 64)).astype(np.float32)
    ours = nearest_code_plain(t(x), t(codes)).numpy()
    pallas = np.asarray(nearest_code_pallas(jnp.asarray(x), jnp.asarray(codes),
                                            interpret=True))
    assert (ours[:16] == 5).all() and (pallas[:16] == 5).all()
    assert not (ours == 77).any() and not (pallas == 77).any()
    np.testing.assert_array_equal(ours, pallas)


def test_nearest_code_rejects_bad_shapes():
    with pytest.raises(ValueError):
        nearest_code(torch.zeros(4, 8), torch.zeros(3, 6))


RQ_CASES = [  # (shared_codebook, latent_shape, code_shape): depth 1 / depth 2, divisor 1 / 2
    (True, (8, 8, 16), (8, 8, 1)),
    (False, (8, 8, 16), (8, 8, 2)),
    (True, (8, 8, 16), (4, 4, 2)),
    (False, (8, 8, 16), (4, 4, 1)),
]


def _rq(shared, latent, code, seed=6):
    kw = dict(latent_shape=latent, code_shape=code, n_embed=32)
    x = np.random.default_rng(seed).normal(size=(2, *latent)).astype(np.float32)
    jmod = jquant.RQBottleneck(shared_codebook=shared, **kw)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    mod = to_port(tquant.RQBottleneck(latent, code, 32, shared_codebook=shared), v)
    return jmod, v, mod, x


@pytest.mark.parametrize("shared,latent,code", RQ_CASES)
def test_rq_bottleneck_call(shared, latent, code):
    jmod, v, mod, x = _rq(shared, latent, code)
    q_j, loss_j, codes_j = japply(jmod, v, x)
    with torch.no_grad():
        q, loss, codes = mod(t(x))
    assert codes.shape == (2, *code) and codes.dtype == torch.int64
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    close(q, q_j, atol=1e-6, rtol=0)
    close(loss, loss_j, atol=0, rtol=5e-6)
    with torch.no_grad():
        quant_list, codes2 = mod.quantize(mod.to_code_shape(t(x)))
    assert len(quant_list) == code[-1] and torch.equal(codes2, codes)
    close(mod.compute_commitment_loss(mod.to_code_shape(t(x)), quant_list), loss_j,
          atol=0, rtol=5e-6)


@pytest.mark.parametrize("shared,latent,code", RQ_CASES[1:3])
def test_rq_embed_variants(shared, latent, code):
    jmod, v, mod, x = _rq(shared, latent, code)
    codes = np.random.default_rng(7).integers(0, 33, (2, *code))
    tc = torch.from_numpy(codes)
    with torch.no_grad():
        for to_latent in (False, True):
            emb, none = mod.embed_code_with_depth(tc, to_latent=to_latent)
            assert none is None
            close(emb, japply(jmod, v, codes, to_latent=to_latent,
                              method="embed_code_with_depth")[0], atol=1e-6, rtol=0)
        for idx, kind in ((0, "select"), (1, "select"), (1, "add")):
            close(mod.embed_partial_code(tc, idx, kind),
                  japply(jmod, v, codes, code_idx=idx, decode_type=kind,
                         method="embed_partial_code"), atol=1e-6, rtol=0)
        with pytest.raises(NotImplementedError):
            mod.embed_partial_code(tc, 0, "mean")


@pytest.mark.parametrize("shared,latent,code", RQ_CASES[:3])
def test_rq_soft_codes(shared, latent, code):
    jmod, v, mod, x = _rq(shared, latent, code)
    soft_j, codes_j = japply(jmod, v, x, temp=0.7, method="get_soft_codes")
    with torch.no_grad():
        soft, codes = mod.get_soft_codes(t(x), temp=0.7)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    close(soft, soft_j, atol=1e-5, rtol=0)


def test_rq_soft_codes_stochastic_shape_and_range():
    """jax.random streams cannot be matched: shape, range and determinism
    under one generator seed only."""
    _, _, mod, x = _rq(False, (8, 8, 16), (4, 4, 2))
    draw = lambda seed: mod.get_soft_codes(
        t(x), temp=2.0, stochastic=True, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        soft, codes = draw(0)
        _, again = draw(0)
    assert soft.shape == (2, 4, 4, 2, 32) and codes.shape == (2, 4, 4, 2)
    assert codes.min() >= 0 and codes.max() < 32
    close(soft.sum(-1), np.ones((2, 4, 4, 2), np.float32), atol=1e-5, rtol=0)
    assert torch.equal(codes, again)


def test_rq_train_mode_is_not_silently_ignored():
    """train=True takes the EMA codebook step (restarts need a generator,
    checked before any buffer moves); train=False moves no buffer."""
    _, _, mod, x = _rq(True, (8, 8, 16), (8, 8, 1))
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    mod(t(x))
    assert all(torch.equal(before[k], v) for k, v in mod.state_dict().items())
    with pytest.raises(ValueError, match="generator"):
        mod(t(x), train=True)
    assert all(torch.equal(before[k], v) for k, v in mod.state_dict().items())
    mod(t(x), train=True, generator=torch.Generator().manual_seed(0))
    assert all(not torch.equal(before[k], v) for k, v in mod.state_dict().items())


def test_codebooks_stay_fp32_under_a_dtype_cast():
    _, _, mod, x = _rq(True, (8, 8, 16), (8, 8, 1))
    half = tquant.RQBottleneck((8, 8, 16), (8, 8, 1), 32, shared_codebook=True)
    half.load_state_dict(mod.state_dict())
    half = half.to(torch.bfloat16)
    book = half.codebooks[0]
    assert book.weight.dtype == torch.float32 and book.embed_ema.dtype == torch.float32
    assert torch.equal(book.weight, mod.codebooks[0].weight)
    with torch.no_grad():
        q, _, codes = half(t(x).to(torch.bfloat16))
    assert q.dtype == torch.bfloat16 and codes.dtype == torch.int64
