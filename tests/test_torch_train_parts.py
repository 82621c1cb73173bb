"""The parts of the port's training step against the JAX package's, on the
CPU in fp32: schedule, Adam, EMA, losses, the PatchGAN discriminator with
its flax-style BatchNorm, LPIPS and its lpips-layout loader, the EMA
codebook update.

Tolerances: the schedule within 1e-6 relative (optax evaluates it in fp32);
Adam within 1e-7 absolute at lr 1e-3 (one fp32 rounding of each update);
EMA within 1e-7; losses within 1e-6 relative; discriminator logits and BN
statistics within 1e-5 (fp32 convs and reductions in another order);
LPIPS values within 1e-5 relative and its input gradient within 1e-4 of its
largest magnitude (He-scaled VGG, see `small_lpips`); the codebook update
within 1e-5.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from pgtformer_tpu.models.quantizer import ema_codebook_update as jax_ema_codebook_update
from pgtformer_tpu.models.vqgan import VQGANDiscriminator as JaxDisc
from pgtformer_tpu.train import ema as jema
from pgtformer_tpu.train import losses as JL
from pgtformer_tpu.train import schedule as jsched
from pgtformer_tpu.train.lpips import LPIPS as JaxLPIPS
from pgtformer_tpu.train.lpips import port_lpips_torch_weights as jax_port_lpips
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.models.quantizer import ema_codebook_update
from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
from pgtformer_tpu_torch.train import ema as tema
from pgtformer_tpu_torch.train import losses as TL
from pgtformer_tpu_torch.train import schedule as tsched
from pgtformer_tpu_torch.train.lpips import LPIPS, make_lpips_fn, port_lpips_torch_weights
from tests.test_torch_common import (  # noqa: F401
    SMALL_DISC, one_torch_thread, random_variables, small_lpips, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(17)


@pytest.fixture(scope="module")
def lpips():
    return small_lpips()


@pytest.mark.parametrize("warmup", [-1, 0, 7])
def test_schedule_matches_optax(warmup):
    """lr over 0 ... 3 * milestone; with warm-up the lr at count 0 is exactly
    0 and the milestones count from the warm-up's end."""
    ms = (10, 20)
    ref = jsched.multistep_with_warmup(2e-4, ms, 0.5, warmup)
    ours = tsched.multistep_with_warmup(2e-4, ms, 0.5, warmup)
    for c in range(3 * ms[-1] + (warmup if warmup > 0 else 0)):
        np.testing.assert_allclose(ours(c), float(ref(c)), rtol=1e-6, atol=0, err_msg=str(c))
    if warmup > 0:
        assert ours(0) == 0.0
        assert ours(warmup + ms[0] - 1) == 2e-4 and ours(warmup + ms[0]) == 1e-4


@pytest.mark.parametrize("steps,warmup", [(1, -1), (3, -1), (3, 2)])
def test_adam_matches_optax(steps, warmup):
    """Adam(0.5, 0.9), eps 1e-8, stepped by the LambdaLR, on identical
    gradients: the parameters after 1 and 3 steps (with a warm-up, step 0
    moves nothing)."""
    shapes = [(5, 3), (7,)]
    p0 = [RNG.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[RNG.normal(size=s).astype(np.float32) for s in shapes] for _ in range(steps)]
    tx = jsched.make_adam(jsched.multistep_with_warmup(1e-3, (2,), 0.5, warmup))
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    params = [torch.from_numpy(a.copy()).requires_grad_() for a in p0]
    opt, sched = tsched.make_adam(params, tsched.multistep_with_warmup(1e-3, (2,), 0.5, warmup))
    for i, g in enumerate(grads):
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a)
        opt.step()
        sched.step()
        if warmup > 0 and i == 0:
            assert all(np.array_equal(p.detach().numpy(), a) for p, a in zip(params, p0))
    assert opt.param_groups[0]["betas"] == (0.5, 0.9) and opt.param_groups[0]["eps"] == 1e-8
    for p, r in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r), rtol=0, atol=1e-7)


def test_ema_matches_jax():
    params = {"a": RNG.normal(size=(4, 3)).astype(np.float32),
              "b": RNG.normal(size=(6,)).astype(np.float32)}
    ema_j = jema.ema_init(params)
    ema_t = tema.ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(3):
        params = {k: v + RNG.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        ema_j = jema.ema_update(ema_j, params, 0.999)
        out = tema.ema_update(ema_t, {k: torch.from_numpy(v) for k, v in params.items()}, 0.999)
        assert out is ema_t
    for k in params:
        assert ema_t[k].dtype == torch.float32
        np.testing.assert_allclose(ema_t[k].numpy(), np.asarray(ema_j[k]), rtol=0, atol=1e-7)


def _pair(shape):
    return (RNG.uniform(0, 1, shape).astype(np.float32),
            RNG.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name", ["l1", "mse", "grad_l1", "ce", "focal", "focal_alpha",
                                  "hinge_g", "hinge_d", "vanilla_g", "vanilla_d",
                                  "temporal_lpips"])
def test_losses_match_jax(name, lpips):
    """Each loss's value, and its gradient with respect to the prediction,
    on the same inputs."""
    a, b = _pair((2, 3, 8, 8, 3))
    logits = RNG.normal(size=(6, 4, 4, 1, 16)).astype(np.float32) * 3
    codes = RNG.integers(0, 16, (6, 4, 4, 1))
    jfn, tfn, _ = lpips
    cases = {
        "l1": (lambda x: JL.l1_loss(x, b, 0.7),
               lambda x: TL.l1_loss(x, torch.from_numpy(b), 0.7), a),
        "mse": (lambda x: JL.mse_loss(x, b, 0.7),
                lambda x: TL.mse_loss(x, torch.from_numpy(b), 0.7), a),
        "grad_l1": (lambda x: JL.grad_l1_loss(x, b, 0.9, (0.2, 0.05, 0.05), 3),
                    lambda x: TL.grad_l1_loss(x, torch.from_numpy(b), 0.9,
                                              (0.2, 0.05, 0.05), 3), a),
        "ce": (lambda x: JL.cross_entropy_loss(x, codes, 0.5),
               lambda x: TL.cross_entropy_loss(x, torch.from_numpy(codes), 0.5), logits),
        "focal": (lambda x: JL.focal_loss(x, codes, 0.5),
                  lambda x: TL.focal_loss(x, torch.from_numpy(codes), 0.5), logits),
        "focal_alpha": (lambda x: JL.focal_loss(x, codes, 1.0, 2.0, 0.25),
                        lambda x: TL.focal_loss(x, torch.from_numpy(codes), 1.0, 2.0, 0.25),
                        logits),
        "hinge_g": (lambda x: JL.HingeGANLoss("hinge", 0.75).g_loss(x),
                    lambda x: TL.HingeGANLoss("hinge", 0.75).g_loss(x), logits),
        "hinge_d": (lambda x: JL.HingeGANLoss("hinge").d_loss(x, -x * 0.5),
                    lambda x: TL.HingeGANLoss("hinge").d_loss(x, -x * 0.5), logits),
        "vanilla_g": (lambda x: JL.HingeGANLoss("vanilla", 0.75).g_loss(x),
                      lambda x: TL.HingeGANLoss("vanilla", 0.75).g_loss(x), logits),
        "vanilla_d": (lambda x: JL.HingeGANLoss("vanilla").d_loss(x, -x * 0.5),
                      lambda x: TL.HingeGANLoss("vanilla").d_loss(x, -x * 0.5), logits),
        "temporal_lpips": (lambda x: JL.temporal_lpips_loss(jfn, x, b, 3, 0.8),
                           lambda x: TL.temporal_lpips_loss(tfn, x, torch.from_numpy(b), 3, 0.8),
                           RNG.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)),
    }
    if name == "temporal_lpips":
        b = RNG.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jf, tf, x = cases[name]
    val, g = jax.jit(jax.value_and_grad(jf))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    ours = tf(xt)
    ours.backward()
    assert ours.dtype == torch.float32 and ours.dim() == 0
    np.testing.assert_allclose(ours.item(), float(val), rtol=1e-6 if name != "temporal_lpips"
                               else 1e-5)
    g = np.asarray(g)
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())
    with pytest.raises(ValueError, match="gan_type"):
        TL.HingeGANLoss("wgan")


def test_discriminator_bn_statistics_thread_like_flax():
    """Three train-mode passes (the generator's fake pass, then the
    discriminator's real and fake passes) thread the running statistics
    (biased batch variance, momentum 0.9) as flax's `batch_stats`; eval
    mode then normalizes with them."""
    x1, x2, x3 = (RNG.normal(size=(4, 32, 32, 3)).astype(np.float32) for _ in range(3))
    jd = JaxDisc(**SMALL_DISC)
    v = random_variables(jd, x1, seed=9, train=False)
    sd = flax_to_state_dict(v)
    port = VQGANDiscriminator(**SMALL_DISC)
    assert set(port.state_dict()) == set(sd)        # strict load, no num_batches_tracked
    port = to_port(port, v)
    bs = v["batch_stats"]
    for x in (x1, x2, x3):
        ref, upd = jd.apply({"params": v["params"], "batch_stats": bs}, x, train=True,
                            mutable=["batch_stats"])
        bs = upd["batch_stats"]
        out = port(torch.from_numpy(x), train=True)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref_stats = flax_to_state_dict({"batch_stats": bs})
    for k, r in ref_stats.items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(), r, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    port(torch.from_numpy(x1), train=True, update_stats=False)
    assert all(torch.equal(before[k], t) for k, t in port.state_dict().items())
    ref = jd.apply({"params": v["params"], "batch_stats": bs}, x1, train=False)
    np.testing.assert_allclose(port(torch.from_numpy(x1)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_lpips_matches_jax(lpips):
    """Values, and the gradient with respect to the first input, at full
    head weight."""
    jfn, tfn, _ = lpips
    x, y = _pair((3, 32, 32, 3))
    val, g = jax.jit(jax.value_and_grad(lambda a: jnp.mean(jfn(a, y))))(jnp.asarray(x))
    np.testing.assert_allclose(tfn(torch.from_numpy(x), torch.from_numpy(y)).mean().item(),
                               float(val), rtol=1e-5)
    xt = torch.from_numpy(x).requires_grad_()
    tfn(xt, torch.from_numpy(y)).mean().backward()
    g = np.asarray(g)
    np.testing.assert_allclose(xt.grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max())


def _lpips_layout(v) -> dict:
    """The JAX LPIPS variables as an `lpips.LPIPS(net='vgg')` state_dict:
    torchvision's VGG16 `features` indices cut into five slices, heads as
    [1, C, 1, 1]."""
    slices = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21), 5: (24, 26, 28)}
    idx = [(s, i) for s, ids in slices.items() for i in ids]
    p = v["params"]
    sd = {}
    for n, (s, i) in enumerate(idx):
        conv = p["vgg"][f"conv_{n}"]
        sd[f"net.slice{s}.{i}.weight"] = np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy()
        sd[f"net.slice{s}.{i}.bias"] = np.asarray(conv["bias"])
    for n in range(5):
        sd[f"lin{n}.model.1.weight"] = np.asarray(p[f"lin_{n}"]).reshape(1, -1, 1, 1)
    return sd


def test_lpips_layout_loader_and_random_default(capsys):
    """An lpips-layout state_dict loads into both packages alike (the
    port's loader beside the JAX package's); without one, make_lpips_fn
    warns and runs its seeded random VGG, deterministically."""
    _, _, v = small_lpips(seed=8)
    sd = _lpips_layout(v)
    jm = JaxLPIPS()
    z = jnp.zeros((1, 32, 32, 3))
    jv = jax_port_lpips(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), z, z)), sd)
    ours = port_lpips_torch_weights(LPIPS(), {k: torch.from_numpy(a) for k, a in sd.items()})
    x, y = _pair((2, 32, 32, 3))
    with torch.no_grad():
        out = ours(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax.jit(jm.apply)(jv, x, y)), rtol=1e-5)
    fn = make_lpips_fn(torch_state_dict={k: torch.from_numpy(a) for k, a in sd.items()},
                       device="cpu")
    assert not fn.random_weights and "WARNING" not in capsys.readouterr().err
    np.testing.assert_allclose(fn(torch.from_numpy(x), torch.from_numpy(y)).numpy(), out,
                               rtol=1e-6)
    with pytest.raises(KeyError, match="VGG convs"):
        port_lpips_torch_weights(LPIPS(), {"net.slice1.0.weight": torch.zeros(64, 3, 3, 3)})
    a, b = make_lpips_fn(device="cpu"), make_lpips_fn(device="cpu", warn_random=False)
    assert a.random_weights and "RANDOM VGG" in capsys.readouterr().err
    assert not any(p.requires_grad for p in a.module.parameters())
    assert torch.equal(a(torch.from_numpy(x), torch.from_numpy(y)),
                       b(torch.from_numpy(x), torch.from_numpy(y)))


def _codebook_case(n_vectors, n_embed=16, dim=8, seed=0):
    r = np.random.default_rng(seed)
    weight = r.normal(size=(n_embed + 1, dim)).astype(np.float32)
    weight[-1] = 0
    cluster = r.uniform(0, 2, n_embed).astype(np.float32)
    embed_ema = r.normal(size=(n_embed, dim)).astype(np.float32)
    vecs = r.normal(size=(n_vectors, dim)).astype(np.float32)
    idx = r.integers(0, n_embed // 2, n_vectors)        # half the codes unused
    return weight, cluster, embed_ema, vecs, idx


def _port_update(case, restart, generator=None):
    w, c, e, vecs, idx = (torch.from_numpy(np.array(a)) for a in case)
    out = ema_codebook_update(w, c, e, vecs, idx, decay=0.9, restart_unused_codes=restart,
                              generator=generator)
    assert out[0] is w and out[1] is c and out[2] is e      # in place, on the buffers
    return [a.numpy() for a in out]


@pytest.mark.parametrize("n_vectors", [40, 10])
def test_ema_codebook_update_without_restart_matches_jax(n_vectors):
    case = _codebook_case(n_vectors)
    ref = jax_ema_codebook_update(*(jnp.asarray(a) for a in case), decay=0.9,
                                  restart_unused_codes=False, rng=None)
    ours = _port_update(case, restart=False)
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-5, atol=1e-5)
    assert np.array_equal(ours[0][-1], np.zeros(8, np.float32))     # the padding row


@pytest.mark.parametrize("n_vectors", [40, 10])
def test_ema_codebook_update_restarts(n_vectors):
    """Restarts: deterministic under a seeded generator; only the codes used
    less than once take new rows, each a batch vector (with fewer vectors
    than codes: a batch vector plus uniform noise below 0.01/sqrt(D)); the
    used codes are as without restarts; the restarted counts are 1."""
    case = _codebook_case(n_vectors, seed=3)
    gen = lambda: torch.Generator().manual_seed(5)
    a = _port_update(case, True, gen())
    b = _port_update(case, True, gen())
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    c = _port_update(case, True, torch.Generator().manual_seed(6))
    assert not np.array_equal(a[2], c[2])
    plain = _port_update(case, False)
    used = plain[1] >= 1.0
    assert used.any() and (~used).any()
    np.testing.assert_array_equal(a[2][used], plain[2][used])
    assert np.all(a[1][~used] == 1.0) and np.array_equal(a[1][used], plain[1][used])
    assert not np.allclose(a[2][~used], plain[2][~used])
    vecs = case[3]
    for row in a[2][~used]:
        d = row[None, :] - vecs
        if n_vectors >= 16:
            assert np.any(np.all(d == 0, axis=1))
        else:
            assert np.any(np.all((d >= 0) & (d < 0.01 / math.sqrt(8)), axis=1))
    with pytest.raises(ValueError, match="generator"):
        _port_update(case, True, None)
