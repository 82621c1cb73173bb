"""One and two steps of the port's PGTFormerTrainer against the JAX
package's, for stages II, III and IV, on the CPU in fp32, at the small
geometry of tests/test_torch_common.py.

Both trainers start from one seeded JAX variable tree per network (the
stage-I teacher, the student, the PatchGAN with its BN statistics, LPIPS)
and take the same uint8 batch ({"lq", "gt"}: one clip of 3 frames), GAN on
from step 0 (III, IV), no warm-up, fixed GAN weight.

Tolerances, as in test_torch_train_stage1.py (whose docstring gives the
reasons): metrics within 1e-5 relative; every gradient tensor within 1e-4
of its own largest magnitude, or of 1e-2 of the whole gradient's where that
is larger, and a trainable parameter that the port's graph does not reach
(stage II's decoder side) has an all-zero JAX gradient; codebook buffers
and BN statistics within 1e-5; after two steps the EMA within 1e-6, and
every student and discriminator element whose JAX gradient in both steps
exceeds 1e-3 of its leaf's scale within 1e-2 * lr
(`assert_two_steps_match`; the parameters with no port gradient, frozen or
unreached, equal JAX's exactly).  Frozen parameters and buffers, and the
teacher, are bit-identical before and after.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import optax
import torch

from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
from pgtformer_tpu.models.vae import TDCRQVAE3 as JaxTDCRQVAE3
from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
from pgtformer_tpu.train import stages as J
from pgtformer_tpu.train.state import DiscriminatorState
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.train import stages as P
from tests.test_torch_common import (
    SMALL_DISC, assert_grads_match, assert_metrics_match, assert_two_steps_match,
    grad_capture, one_torch_thread, port_grads, random_variables, small_configs, small_lpips)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STAGES = ["II", "III", "IV"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _snapshot(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """{stage: (JAX states and metrics, port records)}, built on first use."""
    jc, tc = small_configs()
    rng = np.random.default_rng(21)
    gt = rng.integers(0, 256, (1, 3, 32, 32, 3), dtype=np.uint8)
    noise = rng.integers(-20, 21, gt.shape)
    lq = np.clip(gt.astype(np.int64) + noise, 0, 255).astype(np.uint8)
    lqf = lq.astype(np.float32) / 255
    t_vars = random_variables(JaxTDCRQVAE3(jc.vqvae), gt.astype(np.float32) / 255, seed=4)
    s_vars = random_variables(JaxPGTFormer(jc), lqf, seed=5, w=1.0)
    d_vars = random_variables(JaxDisc(**SMALL_DISC), lqf[0], seed=6, train=False)
    jfn, tfn, _ = small_lpips(heads=1e-2)
    batch = {"lq": lq, "gt": gt}

    def jax_step(stage):
        """The JAX step of `stage` with its optimizers wrapped by
        `grad_capture`, compiled, and its initial state."""
        jhp = dataclasses.replace(J.STAGE_HYPERS[stage], warmup_iter=-1)
        jtr = J.PGTFormerTrainer(jc, stage, jhp, lpips_fn=jfn, disc=JaxDisc(**SMALL_DISC))
        s0 = jtr.init_state(jax.random.PRNGKey(0), lqf, t_vars, s_vars)
        opt_g, opt_d = (optax.chain(grad_capture(), o) for o in jtr._opts)
        jtr._opts = (opt_g, opt_d)
        d = None
        if jhp.use_gan:
            d = DiscriminatorState(params=d_vars["params"], opt_state=opt_d.init(d_vars["params"]),
                                   batch_stats=d_vars["batch_stats"])
        s0 = s0.replace(g=s0.g.replace(opt_state=opt_g.init(s0.g.params)), d=d)
        return jtr.make_step().lower(s0, batch).compile(), s0

    # one stage's XLA compile overlaps the next one's tracing
    with ThreadPoolExecutor(len(STAGES)) as pool:
        compiled = dict(zip(STAGES, pool.map(jax_step, STAGES)))
    cache = {}

    def run(stage):
        if stage in cache:
            return cache[stage]
        step, s0 = compiled[stage]
        s1, m1 = step(s0, batch)
        s2, _ = step(s1, batch)
        jax_out = dict(m1=_np(m1), s1=_np(s1), s2=_np(s2))

        phs = dataclasses.replace(P.STAGE_HYPERS[stage], warmup_iter=-1)
        ptr = P.PGTFormerTrainer(tc, stage, phs, lpips_fn=tfn, device="cpu",
                                 disc=VQGANDiscriminator(**SMALL_DISC))
        state = ptr.init_state(torch.Generator().manual_seed(0),
                               flax_to_state_dict(t_vars), flax_to_state_dict(s_vars),
                               flax_to_state_dict(d_vars))
        rec = dict(model0=_snapshot(ptr.model), teacher0=_snapshot(ptr.teacher))
        pstep = ptr.make_step()
        tb = {"lq": torch.from_numpy(lq), "gt": torch.from_numpy(gt)}
        state, pm1 = pstep(state, tb)
        rec.update(m1=pm1, g_grads=port_grads(state.g.params), model1=_snapshot(ptr.model))
        if state.d is not None:
            rec.update(d_grads=port_grads(state.d.params), disc1=_snapshot(ptr.disc))
        state, _ = pstep(state, tb)
        rec.update(state=state, trainer=ptr, model2=_snapshot(ptr.model),
                   teacher2=_snapshot(ptr.teacher))
        cache[stage] = (jax_out, rec)
        return cache[stage]

    return run


@pytest.mark.parametrize("stage", STAGES)
def test_stage_metrics_and_gradients(runs, stage):
    jax_out, rec = runs(stage)
    assert_metrics_match(rec["m1"], jax_out["m1"])
    ptr = rec["trainer"]
    trainable = [n for n, p in rec["state"].g.params.items() if p.requires_grad]
    assert trainable and set(rec["g_grads"]) <= set(trainable)
    if stage != "II":                  # code_only leaves the decoder side unreached
        assert set(rec["g_grads"]) == set(trainable)
    assert_grads_match(rec["g_grads"], jax_out["s1"].g.opt_state[0], trainable)
    if stage == "II":
        assert rec["state"].d is None and "l_d" not in rec["m1"]
    else:
        d_names = list(rec["state"].d.params)
        assert len(rec["d_grads"]) == len(d_names)
        assert_grads_match(rec["d_grads"], jax_out["s1"].d.opt_state[0], d_names)
    frozen = set(ptr.frozen_modules())
    assert {"decoder", "conditionnet", "post_quant_conv"} <= frozen
    assert not any(n.split(".")[0] in frozen for n in trainable)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_frozen_parts_untouched(runs, stage):
    """Frozen parameters, every buffer of the student (codebooks, the parsing
    prior's BN statistics) and the whole teacher are bit-identical after two
    steps; the frozen parameters are neither in the optimizer nor
    requires_grad.  The discriminator's statistics moved as JAX's did."""
    jax_out, rec = runs(stage)
    state, ptr = rec["state"], rec["trainer"]
    params = state.g.params
    frozen = [n for n, p in params.items() if not p.requires_grad]
    assert frozen
    in_opt = {id(p) for grp in ptr.opt_g.param_groups for p in grp["params"]}
    assert not any(id(params[n]) in in_opt for n in frozen)
    for k, v in rec["model0"].items():
        if k in frozen or k not in params:          # frozen parameter or buffer
            assert np.array_equal(rec["model2"][k], v), k
    for k, v in rec["teacher0"].items():
        assert np.array_equal(rec["teacher2"][k], v), k
    assert all(not p.requires_grad for p in ptr.teacher.parameters())
    ref = flax_to_state_dict({"params": jax_out["s2"].g.params})
    for n in frozen:
        assert np.array_equal(params[n].detach().numpy(), ref[n]), n
    if stage != "II":
        bs = flax_to_state_dict({"batch_stats": jax_out["s1"].d.batch_stats})
        for k, r in bs.items():
            np.testing.assert_allclose(rec["disc1"][k], r, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_parameters_after_two_steps(runs, stage):
    jax_out, rec = runs(stage)
    state = rec["state"]
    assert state.step == 2
    s1, s2 = jax_out["s1"], jax_out["s2"]
    hp = P.STAGE_HYPERS[stage]
    assert_two_steps_match(state.g.params, s2.g.params, s1.g.opt_state[0],
                           s2.g.opt_state[0], hp.lr_g, names=list(rec["g_grads"]))
    if state.d is not None:
        assert_two_steps_match(state.d.params, s2.d.params, s1.d.opt_state[0],
                               s2.d.opt_state[0], hp.lr_d)
    ref = flax_to_state_dict({"params": s2.g.ema_params})
    assert set(ref) == set(state.g.ema_params)
    for k, r in ref.items():
        np.testing.assert_allclose(state.g.ema_params[k].numpy(), r, rtol=0, atol=1e-6,
                                   err_msg=k)
    trainable = [n for n, p in state.g.params.items() if p.requires_grad]
    moved = [n for n in trainable if not np.array_equal(rec["model2"][n], rec["model0"][n])]
    assert len(moved) >= (len(trainable) * 2) // 3
