"""The port's bf16 path against the JAX package's bf16 path (CPU).

The parity tests of the other files run fp32.  Here the port's modules are
cast to bf16 as a serving model is, and held to where the JAX package
rounds: flax keeps every parameter fp32, applies norm affines and BatchNorm
statistics in fp32 and rounds the output once; the parsing prior's input
is normalized in fp32; the phase kernels of the subpixel upsample are
summed from the fp32 taps and rounded once."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
import torch.nn.functional as F

import pgtformer_tpu.models.parser as jparser
import pgtformer_tpu.nn.blocks as jblocks
from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
from pgtformer_tpu.ops.pallas_conv import phase_kernels_2x2
import pgtformer_tpu_torch.models.parser as tparser
import pgtformer_tpu_torch.nn.blocks as tb
from pgtformer_tpu_torch.models.pgtformer import PGTFormer
from tests.test_torch_common import random_variables, small_configs, t, to_port

BF16 = torch.bfloat16


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in bf16 ulps of the larger magnitude (a, b bf16 values)."""
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.maximum(m, np.finfo(np.float32).tiny))) - 7)
    return np.abs(a - b) / ulp


def _bf16_input(rng, shape, scale=1.0, shift=0.0):
    x = (rng.normal(size=shape) * scale + shift).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _norm_cases():
    """(name, flax module, its variables, port module loaded from them)."""
    rng = np.random.default_rng(11)
    C = 64
    scale = (1.0 + rng.normal(size=C) * 0.01).astype(np.float32)
    bias = (rng.normal(size=C) * 0.05).astype(np.float32)
    mean = (rng.normal(size=C) * 0.1).astype(np.float32)
    var = rng.uniform(0.5, 1.5, C).astype(np.float32)
    params = {"scale": scale, "bias": bias}
    ln = tb.layer_norm(C)
    ln.load_state_dict({"weight": t(scale), "bias": t(bias)})
    gn = tb.GroupNorm(C)
    gn.load_state_dict({"weight": t(scale), "bias": t(bias)})
    bn = tparser.FrozenBatchNorm(C)
    bn.load_state_dict({"weight": t(scale), "bias": t(bias), "running_mean": t(mean),
                        "running_var": t(var)})
    return {
        "layer_norm": (fnn.LayerNorm(epsilon=1e-6, dtype=jnp.bfloat16),
                       {"params": params}, ln),
        "group_norm": (jblocks.group_norm(jnp.bfloat16), {"params": params}, gn),
        "frozen_batch_norm": (jparser._bn(jnp.bfloat16),
                              {"params": params,
                               "batch_stats": {"mean": mean, "var": var}}, bn),
    }


@pytest.mark.parametrize("name", ["layer_norm", "group_norm", "frozen_batch_norm"])
def test_norm_bf16_matches_flax_bf16(name):
    """Non-unit scales: each output within one bf16 ulp of flax's, at most
    1% of them off at all (an affine held in bf16 puts ~25% one ulp off)."""
    jmod, variables, mod = _norm_cases()[name]
    x = _bf16_input(np.random.default_rng(12), (4, 16, 16, 64), 1.5, 0.3)
    want = _np32(jmod.apply(variables, jnp.asarray(x, jnp.bfloat16)))
    mod = mod.to(BF16)
    with torch.no_grad():
        got = mod(t(x).to(BF16))
    assert got.dtype == BF16
    d = _ulps(_np32(got), want)
    print(f"{name}: max {d.max()} ulp, {(d > 0).mean():.6f} of outputs off")
    assert d.max() <= 1.0 and (d > 0).mean() <= 0.01, (d.max(), (d > 0).mean())
    assert all(p.dtype == torch.float32 for p in mod.state_dict().values())


def test_upsample_phase_kernels_round_once_from_fp32_taps():
    """`Upsample.kernel_weights` of a bf16 module: the JAX package's phase
    kernels of the fp32 parameters, rounded once, bit for bit; without
    `subpixel` (the VQGAN family's upsample) the forward still rounds the
    weight to bf16 at use, as a bf16-stored weight did.  The subpixel plans
    are held to JAX's in tests/test_torch_eval_plans.py."""
    rng = np.random.default_rng(13)
    C = 64
    k3 = (rng.normal(size=(3, 3, C, C)) / 24.0).astype(np.float32)     # HWIO
    b = (rng.normal(size=C) * 0.05).astype(np.float32)
    up = tb.Upsample(C, subpixel=False)
    up.load_state_dict({"conv.weight": t(k3).permute(3, 2, 0, 1), "conv.bias": t(b)})
    up = up.to(BF16)
    k2, bias = up.kernel_weights()
    want = np.asarray(phase_kernels_2x2(jnp.asarray(k3)).astype(jnp.bfloat16))
    assert k2.dtype == BF16
    np.testing.assert_array_equal(k2.view(torch.int16).numpy(), want.view(np.int16))
    assert torch.equal(bias, t(b))
    x = t(_bf16_input(rng, (2, 8, 8, C))).to(BF16)
    with torch.no_grad():
        got = up(x)
        stock = torch.nn.Conv2d(C, C, 3, padding=1)
        stock.load_state_dict({"weight": t(k3).permute(3, 2, 0, 1), "bias": t(b)})
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        ref = stock.to(BF16)(y).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def small_models():
    """(JAX fp32 model, JAX bf16 model, port model factory) at the small
    geometry; JAX applies are jitted once per dtype and reused across
    seeds."""
    jc, tc = small_configs()
    j32, j16 = JaxPGTFormer(jc), JaxPGTFormer(jc, dtype=jnp.bfloat16)
    fwd = {m: jax.jit(lambda v, x, m=m: m.apply(v, x, w=1.0)) for m in (j32, j16)}
    enc = {m: jax.jit(lambda v, f, m=m: m.apply(v, f, method="encode_frames"))
           for m in (j32, j16)}

    def port(v):
        return to_port(PGTFormer(tc), v).to(BF16)

    return j32, j16, fwd, enc, port


def _clip(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)


def test_encode_frames_pos_bf16_within_jax_bf16(small_models):
    """The parsing prior (BiSeNet -> convpos) of fp32 frames in a bf16
    model: no further from JAX fp32 than 1.1x JAX bf16's distance, in max
    and in mean.  The trunk rounds x/255 once, as JAX's does."""
    j32, j16, _, enc, port = small_models
    x = _clip(0)
    frames = x.reshape(6, 32, 32, 3)
    v = random_variables(j32, jnp.asarray(x), seed=1, w=1.0)
    pos32, trunk32, _ = enc[j32](v, frames)
    pos16, trunk16, _ = enc[j16](v, frames)
    with torch.no_grad():
        pos, trunk, _ = port(v).encode_frames(t(frames))
    assert pos.dtype == BF16 and trunk.dtype == BF16
    ref = _np32(pos32)
    scale = np.abs(ref).max()
    ours = np.abs(_np32(pos) - ref) / scale
    jaxs = np.abs(_np32(pos16) - ref) / scale
    print(f"pos vs JAX fp32, port bf16: max {ours.max():.6f} mean {ours.mean():.6f}; "
          f"JAX bf16: max {jaxs.max():.6f} mean {jaxs.mean():.6f}")
    assert ours.max() <= 1.1 * jaxs.max() and ours.mean() <= 1.1 * jaxs.mean(), (
        ours.max(), jaxs.max(), ours.mean(), jaxs.mean())
    tref = _np32(trunk32)
    tscale = np.abs(tref).max()
    assert (np.abs(_np32(trunk) - tref).mean() / tscale
            <= 1.1 * np.abs(_np32(trunk16) - tref).mean() / tscale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_bf16_codes_agree_like_jax_bf16(small_models, seed):
    """The whole small forward in bf16 from fp32 frames: the port's codes
    agree with JAX fp32's no worse than JAX bf16's do, less 0.01 (random
    weights leave a few near-ties that either rounding may flip)."""
    j32, j16, fwd, _, port = small_models
    x = _clip(seed)
    v = random_variables(j32, jnp.asarray(x), seed=seed + 1, w=1.0)
    codes32 = np.asarray(jnp.argmax(fwd[j32](v, x)[1], axis=-1))
    codes16 = np.asarray(jnp.argmax(fwd[j16](v, x)[1], axis=-1))
    with torch.no_grad():
        _, logits, _ = port(v)(t(x), w=1.0)
    assert logits.dtype == BF16
    ours = (logits.float().argmax(-1).numpy() == codes32).mean()
    jaxs = (codes16 == codes32).mean()
    print(f"seed {seed}: codes agreeing with JAX fp32, port bf16 {ours:.4f}, JAX bf16 {jaxs:.4f}")
    assert ours >= jaxs - 0.01, (ours, jaxs)
