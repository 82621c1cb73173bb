"""One step of the port's Stage1Trainer (fp32, CPU) with LPIPS at full
weight, against the JAX package's step in fp64 (``jax.enable_x64``: the
variable trees, the autoencoder, the PatchGAN and LPIPS in float64) and in
fp32, at the small geometry of tests/test_torch_common.py.

The other step tests scale LPIPS's heads by 1e-2 (`small_lpips` says why);
this one runs it at full weight.  There the two fp32 steps, the port's and
the JAX package's, each lie up to ~2e-3 of a leaf's scale (`leaf_scales`)
from the fp64 step (measured 2.05e-3 each), while they lie much closer to
each other (measured 9e-6 with torch on one thread, as here, and 2.9e-4
on four): most of their rounding is shared (the losses' fp32 casts, the
fp32 uint8 frames).  So this test holds the port to
what that comparison supports:

* metrics within 1e-5 relative of the fp64 step's;
* every gradient leaf of the generator and the discriminator within 3e-3
  of its scale from the fp64 step's, and no farther from it than 1.25
  times the JAX package's own fp32 step plus 1e-4: the port is as close to
  the exact step as the reference is;
* every leaf within 5e-4 of its scale from the JAX fp32 step's.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
from pgtformer_tpu.train import stages as J
from pgtformer_tpu.train.lpips import LPIPS as JaxLPIPS
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.train import stages as P
from tests.test_torch_common import (
    SMALL_DISC, assert_metrics_match, jax_train_state, leaf_scales, one_torch_thread,
    port_grads, random_variables, small_configs, small_lpips)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.asarray(a).dtype == np.float32 else np.asarray(a), tree)


@pytest.fixture(scope="module")
def steps(one_torch_thread):
    """(JAX fp32 (state, metrics), JAX fp64 (state, metrics), port metrics,
    port gradients {"g", "d"}) after one step from one variable tree."""
    jc, tc = small_configs()
    jvq = dataclasses.replace(jc.vqvae, restart_unused_codes=False)
    tvq = dataclasses.replace(tc.vqvae, restart_unused_codes=False)
    rng = np.random.default_rng(11)
    gt = rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8)
    frames = gt.reshape(6, 32, 32, 3).astype(np.float32) / 255
    g_vars = random_variables(JaxTDCRQVAE3(jvq), gt.astype(np.float32) / 255, seed=2)
    d_vars = random_variables(JaxDisc(**SMALL_DISC), frames, seed=3, train=False)
    jfn, tfn, l_vars = small_lpips()

    def jax_step(dtype, gv, dv, lpips_fn):
        hp = dataclasses.replace(J.STAGE_HYPERS["I"], warmup_iter=-1)
        tr = J.Stage1Trainer(jvq, hp, lpips_fn=lpips_fn, dtype=dtype,
                             disc=JaxDisc(**SMALL_DISC, dtype=dtype))
        s1, m1 = tr.make_step()(jax_train_state(tr, gv, dv), gt)
        return jax.tree.map(np.asarray, s1), jax.tree.map(np.asarray, m1)

    j32 = jax_step(jnp.float32, g_vars, d_vars, jfn)
    with jax.enable_x64(True):
        lm, lv = JaxLPIPS(dtype=jnp.float64), _f64(l_vars)
        j64 = jax_step(jnp.float64, _f64(g_vars), _f64(d_vars), lambda a, b: lm.apply(lv, a, b))
    tr = P.Stage1Trainer(tvq, P.StageHyper(warmup_iter=-1), lpips_fn=tfn, device="cpu",
                         disc=VQGANDiscriminator(**SMALL_DISC))
    state = tr.init_state(torch.Generator().manual_seed(0),
                          state_dict=flax_to_state_dict(g_vars),
                          disc_state_dict=flax_to_state_dict(d_vars))
    state, metrics = tr.make_step()(state, torch.from_numpy(gt))
    grads = {"g": port_grads(state.g.params), "d": port_grads(state.d.params)}
    return j32, j64, metrics, grads


def test_full_lpips_step_metrics_match_fp64(steps):
    _, (_, m64), metrics, _ = steps
    assert_metrics_match(metrics, m64)


@pytest.mark.parametrize("net", ["g", "d"])
def test_full_lpips_step_gradients_match_fp64(steps, net):
    (s32, _), (s64, _), _, grads = steps
    ours = grads[net]
    r32 = flax_to_state_dict({"params": getattr(s32, net).opt_state[0]})
    r64 = flax_to_state_dict({"params": getattr(s64, net).opt_state[0]})
    names = list(r64)
    assert set(ours) == set(names) and len(names) >= 10
    scale, scale32 = leaf_scales(r64, names), leaf_scales(r32, names)
    rows = []
    for n in names:
        port64 = np.abs(ours[n] - r64[n]).max() / scale[n]
        jax64 = np.abs(r32[n] - r64[n]).max() / scale[n]
        port32 = np.abs(ours[n] - r32[n]).max() / scale32[n]
        rows.append((port64, jax64, port32, n))
    worst = max(rows)
    print(f"{net}: worst leaf {worst[3]}: port {worst[0]:.3e} and JAX fp32 {worst[1]:.3e} "
          f"from fp64; port {max(r[2] for r in rows):.3e} from JAX fp32 at most")
    for port64, jax64, port32, n in rows:
        assert port64 <= 3e-3, (n, port64)
        assert port64 <= 1.25 * jax64 + 1e-4, (n, port64, jax64)
        assert port32 <= 5e-4, (n, port32)
