"""One and two steps of the port's Stage1Trainer against the JAX package's,
on the CPU in fp32, at the small geometry of tests/test_torch_common.py.

Both trainers start from one seeded JAX variable tree (autoencoder,
codebook, PatchGAN with its BN statistics, LPIPS) and take the same uint8
batch (2 clips of 3 frames), GAN on from step 0, no warm-up, codebook
restarts off (their draws come from different generators; the restart
path is tested in test_torch_train_parts.py), in both `gan_weight_mode`s.

Tolerances: metrics within 1e-5 relative; every gradient tensor within
1e-4 of its own largest magnitude, or of 1e-2 of the whole gradient's where
that is larger (fp32 sums in another order, through ~30 layers;
`assert_grads_match`); codebook buffers and BN statistics within 1e-5.
The LPIPS is conditioned as `small_lpips` explains (its heads at 1e-2);
test_torch_train_fp64.py takes the step with LPIPS at full weight.

Parameters after two steps: the EMA within 1e-6; every generator and
discriminator element whose JAX gradient in both steps exceeds 1e-3 of its
leaf's scale within 1e-2 * lr (`assert_two_steps_match`, which says why
the rest cannot be held: Adam turns a gradient that is rounding noise into
a step of ~lr whose sign rounding sets).
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
from pgtformer_tpu.train import stages as J
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.train import stages as P
from tests.test_torch_common import (
    SMALL_DISC, assert_grads_match, assert_metrics_match, assert_two_steps_match,
    jax_train_state, one_torch_thread, port_grads, random_variables, small_configs,
    small_lpips)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """{mode: (JAX states and metrics, port records)} for each mode, built
    on first use."""
    jc, tc = small_configs()
    jvq = dataclasses.replace(jc.vqvae, restart_unused_codes=False)
    tvq = dataclasses.replace(tc.vqvae, restart_unused_codes=False)
    rng = np.random.default_rng(11)
    gt = rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8)
    frames = gt.reshape(6, 32, 32, 3).astype(np.float32) / 255
    g_vars = random_variables(JaxTDCRQVAE3(jvq), gt.astype(np.float32) / 255, seed=2)
    d_vars = random_variables(JaxDisc(**SMALL_DISC), frames, seed=3, train=False)
    jfn, tfn, _ = small_lpips(heads=1e-2)
    disc0 = {k: v for k, v in flax_to_state_dict(d_vars).items() if k.endswith(("mean", "var"))}
    cache = {}

    def run(mode):
        if mode in cache:
            return cache[mode]
        jhp = dataclasses.replace(J.STAGE_HYPERS["I"], warmup_iter=-1, gan_weight_mode=mode)
        jtr = J.Stage1Trainer(jvq, jhp, lpips_fn=jfn, disc=JaxDisc(**SMALL_DISC))
        s0 = jax_train_state(jtr, g_vars, d_vars)
        step = jtr.make_step()
        s1, m1 = step(s0, gt)
        s2, _ = step(s1, gt)
        jax_out = dict(m1=_np(m1), s1=_np(s1), s2=_np(s2))

        phs = P.StageHyper(warmup_iter=-1, gan_weight_mode=mode)
        ptr = P.Stage1Trainer(tvq, phs, lpips_fn=tfn, device="cpu",
                              disc=VQGANDiscriminator(**SMALL_DISC), use_pallas=False)
        state = ptr.init_state(torch.Generator().manual_seed(0),
                               state_dict=flax_to_state_dict(g_vars),
                               disc_state_dict=flax_to_state_dict(d_vars))
        pstep = ptr.make_step()
        state, pm1 = pstep(state, torch.from_numpy(gt))
        rec = dict(m1=pm1, disc0=disc0, g_grads=port_grads(state.g.params),
                   d_grads=port_grads(state.d.params),
                   model1={k: v.detach().numpy().copy()
                           for k, v in ptr.model.state_dict().items()},
                   disc1={k: v.detach().numpy().copy() for k, v in ptr.disc.state_dict().items()})
        state, _ = pstep(state, torch.from_numpy(gt))
        rec.update(state=state, trainer=ptr)
        cache[mode] = (jax_out, rec)
        return cache[mode]

    return run


MODES = ["fixed", "adaptive"]


@pytest.mark.parametrize("mode", MODES)
def test_stage1_metrics_and_gradients(runs, mode):
    jax_out, rec = runs(mode)
    assert_metrics_match(rec["m1"], jax_out["m1"])
    if mode == "adaptive":
        assert 0 < float(rec["m1"]["d_weight"]) < 1e4
    g_ref = jax_out["s1"].g.opt_state[0]
    names = list(rec["trainer"].model.state_dict())
    params = [n for n in names if n in rec["state"].g.params]
    assert len(params) == len(rec["g_grads"]) > 50     # every parameter got one
    assert_grads_match(rec["g_grads"], g_ref, params)
    d_names = list(rec["state"].d.params)
    assert len(rec["d_grads"]) == len(d_names)
    assert_grads_match(rec["d_grads"], jax_out["s1"].d.opt_state[0], d_names)


@pytest.mark.parametrize("mode", MODES)
def test_stage1_codebook_and_bn_statistics(runs, mode):
    """After one step: the EMA codebook (weight, cluster sizes, sums) and
    the PatchGAN's running statistics, threaded through the generator's
    pass and the discriminator's real and fake passes."""
    jax_out, rec = runs(mode)
    cb = flax_to_state_dict({"codebook": jax_out["s1"].g.codebook})
    assert len(cb) == 3
    for k, ref in cb.items():
        np.testing.assert_allclose(rec["model1"][k], ref, rtol=1e-5, atol=1e-5, err_msg=k)
    bs = flax_to_state_dict({"batch_stats": jax_out["s1"].d.batch_stats})
    assert len(bs) == 4
    for k, ref in bs.items():
        np.testing.assert_allclose(rec["disc1"][k], ref, rtol=1e-5, atol=1e-5, err_msg=k)
    for k, before in rec["disc0"].items():      # the three passes moved them
        assert not np.allclose(rec["disc1"][k], before), k


@pytest.mark.parametrize("mode", MODES)
def test_stage1_parameters_after_two_steps(runs, mode):
    """Generator and discriminator parameters and the generator's EMA after
    two steps; the step counter and the optimizer's step count."""
    jax_out, rec = runs(mode)
    state = rec["state"]
    assert state.step == 2
    s1, s2 = jax_out["s1"], jax_out["s2"]
    lr = P.STAGE_HYPERS["I"].lr_g
    assert_two_steps_match(state.g.params, s2.g.params, s1.g.opt_state[0],
                           s2.g.opt_state[0], lr)
    assert_two_steps_match(state.d.params, s2.d.params, s1.d.opt_state[0],
                           s2.d.opt_state[0], P.STAGE_HYPERS["I"].lr_d)
    ref = flax_to_state_dict({"params": s2.g.ema_params})
    assert set(ref) == set(state.g.ema_params)
    for k, r in ref.items():
        np.testing.assert_allclose(state.g.ema_params[k].numpy(), r, rtol=0, atol=1e-6,
                                   err_msg=k)
    moved = [k for k, p in state.g.params.items()
             if not np.array_equal(p.detach().numpy(), rec["model1"][k])]
    assert len(moved) == len(state.g.params)
    assert all(s["step"] == 2 for s in state.g.opt_state["state"].values())
