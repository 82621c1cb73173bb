"""Shared fixtures of the PyTorch-port parity tests, plus config parity.

The JAX package is the oracle: it runs its XLA path on the CPU, the port
runs its plain PyTorch versions on the CPU, both in fp32 on the same seeded
numpy inputs and the same weights (a seeded numpy tree with the structure
of the JAX module's init, every bias, norm affine and BN statistic
non-trivial, exported to the reference state_dict format for the port).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu_torch.config as tcfg
from pgtformer_tpu_torch.convert import flax_to_state_dict

_DD = dict(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
           num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
_VQ = dict(embed_dim=32, n_embed=64, latent_shape=(16, 16, 32), code_shape=(16, 16, 1))
_PGT = dict(dim_embd=64, n_head=4, n_layers=2, connect_list=("16", "32"), w=1.0, adain=True)


def small_configs():
    """(JAX config, port config) of the small test geometry: 32x32 frames,
    T=3, attention (depth 2, so the shifted block runs) at 16x16."""
    j = jcfg.PGTFormerConfig(vqvae=jcfg.VQVAEConfig(ddconfig=jcfg.DDConfig(**_DD), **_VQ),
                             **_PGT)
    t = tcfg.PGTFormerConfig(vqvae=tcfg.VQVAEConfig(ddconfig=tcfg.DDConfig(**_DD), **_VQ),
                             **_PGT)
    return j, t


def random_variables(module, *args, seed: int = 0, **kwargs):
    """A seeded numpy variable tree with the structure of
    `module.init(key, *args, **kwargs)`, built from `jax.eval_shape` (flax's
    own eager init takes tens of seconds on the CPU at these sizes).
    Kernels are fan-in scaled normals; biases, norm affines, BN statistics
    and the relative-position tables are all non-trivial; each codebook's
    last (padding) row is zero."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kwargs))
    rng = np.random.default_rng(seed)
    leaves, tdef = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, s in leaves:
        name = str(getattr(path[-1], "key", path[-1]))
        shape = s.shape
        if name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            a = rng.normal(size=shape) * 0.1
        elif name == "scale":
            a = 1.0 + rng.normal(size=shape) * 0.1
        elif name in ("bias", "in_proj_bias"):
            a = rng.normal(size=shape) * 0.05
        elif name == "relative_position_bias_table":
            a = rng.normal(size=shape) * 0.5
        elif name in ("kernel", "in_proj_kernel"):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif name.endswith("_cluster_size_ema"):
            a = rng.uniform(0.0, 2.0, shape)
        else:                                   # codebook weight / embed_ema
            a = rng.normal(size=shape)
            if name.endswith("_weight"):
                a[-1] = 0.0
        out.append(np.asarray(a, dtype=s.dtype))
    return jax.tree_util.tree_unflatten(tdef, out)


def japply(module, variables, *args, method=None, **static):
    """`module.apply` under jax.jit: one compile instead of one per op
    (eager flax dispatch takes ~20 s for the small PGTFormer on the CPU).
    Keyword arguments are static."""
    fn = jax.jit(lambda v, *a: module.apply(v, *a, method=method, **static))
    return fn(variables, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                           for a in args])


def to_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX variables into a port module (strict) and set eval mode."""
    sd = flax_to_state_dict(variables)
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(ours, ref, atol=1e-4, rtol=1e-4):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def small_pgt():
    """(JAX model, JAX variables, port model, clip [2,3,32,32,3]) at the
    small geometry, same weights."""
    from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    jc, tc = small_configs()
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jm = JaxPGTFormer(jc)
    v = random_variables(jm, jnp.asarray(x), seed=1, w=1.0)
    return jm, v, to_port(PGTFormer(tc), v), x


@pytest.mark.parametrize("name", ["DDConfig", "VQVAEConfig", "PGTFormerConfig"])
def test_config_dataclasses_match(name):
    """The port's copy of each config dataclass has the same fields and
    defaults as the JAX package's."""
    a = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    b = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is not dataclasses.MISSING:
            assert a[k] == b[k], k


def test_release_config_matches():
    assert dataclasses.asdict(tcfg.RELEASE_PGTFORMER) == dataclasses.asdict(
        jcfg.RELEASE_PGTFORMER)
    j, t_ = small_configs()
    assert dataclasses.asdict(j) == dataclasses.asdict(t_)
    opt = {"network_g": {"type": "PGTFormer", "dim_embd": 256, "w": 0.5,
                         "ddconfig": {"ch": 32, "ch_mult": [1, 2]}, "n_embed": 64}}
    assert dataclasses.asdict(tcfg.pgtformer_config_from_options(opt)) == \
        dataclasses.asdict(jcfg.pgtformer_config_from_options(opt))


# -- training ------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one CPU thread for a module's tests, restored after.  The
    tier-1 run keeps several pytest workers busy on few cores, and torch's
    OpenMP threads then wait on each other: a small training step that takes
    0.3 s on eight threads alone took over 50 s on eight threads beside
    seven busy processes, and 0.7 s on one."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


SMALL_DISC = dict(ndf=16, n_layers=2)   # a PatchGAN whose logits survive 32x32 frames


def grad_capture():
    """An optax transformation that passes the gradients on unchanged and
    keeps them in its state: chained before a JAX trainer's optimizer, it
    exposes the gradients of a jitted step (`opt_state[0]`)."""
    import optax
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


def small_lpips(seed: int = 7, heads: float = 1.0):
    """(JAX lpips_fn, port lpips_fn, JAX variables): one seeded LPIPS
    variable tree (negative head weights included) in both packages.

    The VGG's kernels are He-scaled (fan-in normal times sqrt(2)) and its
    biases small (0.005), as a trained VGG's activations keep their scale
    through the ReLUs.  With fan-in kernels and 0.05 biases the deep taps are
    bias-dominated and their differences cancel: the fp32 gradients of both
    packages then lie ~1e-3 (relative) from an fp64 evaluation.

    `heads` scales the five heads.  The training-step tests pass 1e-2: LPIPS
    is a ReLU network, and a pre-activation within rounding of 0 switches
    its ReLU's gradient between two fp32 forwards that differ in the last
    bit (the two packages', or fp32 and fp64), which moves LPIPS's gradient
    through a 32x32 generator by up to ~1e-3 of its scale (measured: the
    port 8.4e-4 from JAX at stage III, JAX fp32 3e-4 from JAX fp64 at stage
    I).  At 1e-2 the LPIPS term still runs, and its value is held to 1e-5,
    but its share of the gradient sits below the gradients' 1e-4 tolerance;
    test_torch_train_parts.py holds LPIPS and its input gradient at full
    weight, and test_torch_train_fp64.py a whole step with LPIPS at full
    weight against an fp64 JAX step."""
    from pgtformer_tpu.train.lpips import LPIPS as JaxLPIPS
    from pgtformer_tpu_torch.train.lpips import LPIPS
    jm = JaxLPIPS()
    z = jnp.zeros((1, 32, 32, 3), jnp.float32)
    v = random_variables(jm, z, z, seed=seed)
    v = jax.tree_util.tree_map_with_path(
        lambda path, a: a * (np.sqrt(2.0) if path[-1].key == "kernel" else
                             0.1 if path[-1].key == "bias" else heads), v)
    port = to_port(LPIPS(), v).requires_grad_(False)
    return (lambda a, b: jm.apply(v, a, b)), (lambda a, b: port(a.float(), b.float())), v


def jax_train_state(trainer, g_vars, d_vars):
    """A JAX TrainState at step 0 over the given variable trees, with the
    trainer's optimizers wrapped by :func:`grad_capture` (so the state after
    a step holds that step's gradients)."""
    import optax
    from pgtformer_tpu.train.ema import ema_init
    from pgtformer_tpu.train.state import DiscriminatorState, GeneratorState, TrainState
    opt_g = optax.chain(grad_capture(), trainer.opt_g)
    opt_d = optax.chain(grad_capture(), trainer.opt_d)
    trainer.opt_g, trainer.opt_d = opt_g, opt_d
    g = GeneratorState(params=g_vars["params"], ema_params=ema_init(g_vars["params"]),
                       opt_state=opt_g.init(g_vars["params"]), codebook=g_vars.get("codebook"))
    d = DiscriminatorState(params=d_vars["params"], opt_state=opt_d.init(d_vars["params"]),
                           batch_stats=d_vars["batch_stats"])
    return TrainState(step=jnp.zeros((), jnp.int32), g=g, d=d, rng=jax.random.PRNGKey(0))


def port_grads(params) -> dict:
    """{name: gradient as numpy} of the parameters that have one."""
    return {n: p.grad.detach().numpy().copy() for n, p in params.items() if p.grad is not None}


GRAD_FLOOR = 1e-2   # a leaf's scale is at least this share of the whole gradient's


def leaf_scales(ref: dict, names) -> dict:
    """{name: scale} of each gradient leaf: its own largest magnitude, or
    GRAD_FLOOR times the whole gradient's largest magnitude where that is
    larger.  A leaf whose exact gradient is 0 (a conv bias right before a
    one-channel-per-group GroupNorm) holds only rounding noise, ~1e-17 of
    the whole gradient, so its own magnitude is no scale; the floor holds
    it, and every other small leaf, to 1e-2 of the largest."""
    top = max(np.abs(np.asarray(ref[n])).max() for n in names)
    assert top > 0
    return {n: max(np.abs(np.asarray(ref[n])).max(), GRAD_FLOOR * top) for n in names}


def assert_grads_match(ours: dict, ref_tree, names, rel: float = 1e-4):
    """Every named gradient tensor within `rel` times its leaf's scale
    (:func:`leaf_scales`); a parameter the port's graph did not reach must
    have an all-zero JAX gradient.  Prints the leaves held by the floor."""
    ref = flax_to_state_dict({"params": ref_tree})
    scale = leaf_scales(ref, names)
    top = max(scale.values())
    floored = sorted(n for n in names if scale[n] == GRAD_FLOOR * top and n in ours)
    print(f"{len(floored)} of {len(names)} gradient leaves below {GRAD_FLOOR} of the "
          f"largest, held to {rel} of that: {floored}")
    bad = []
    for n in names:
        r = np.asarray(ref[n])
        if n not in ours:
            assert not r.any(), f"{n}: no port gradient, JAX's is non-zero"
            continue
        err = np.abs(ours[n] - r).max()
        if err > rel * scale[n]:
            bad.append((err / scale[n], n))
    assert not bad, sorted(bad, reverse=True)[:10]


def assert_two_steps_match(ours: dict, ref_tree, g1_tree, g2_tree, lr: float,
                           names=None, rel: float = 1e-4):
    """Parameters after two Adam steps against the JAX package's.

    Adam moves an element by lr * m/sqrt(v), about lr whatever the
    gradient's size, so an element whose gradient lies within the
    gradients' agreement (`rel` of its leaf's scale) of 0 takes a step whose
    sign rounding sets, in either package.  The check therefore holds every
    element whose JAX gradient, in both steps, exceeds 10 * rel of its
    leaf's scale (:func:`leaf_scales`) to 1e-2 * lr: a step the wrong way
    or of the wrong size misses by ~lr.  It prints how many elements that
    rule leaves out, and asserts they are under 5%.  `names` (default: every
    parameter) are the leaves held; the others must equal JAX's exactly
    (frozen, or not reached by the step's graph)."""
    ref = flax_to_state_dict({"params": ref_tree})
    g1 = flax_to_state_dict({"params": g1_tree})
    g2 = flax_to_state_dict({"params": g2_tree})
    assert set(ref) == set(ours)
    names = sorted(ref if names is None else names)
    for n in set(ref) - set(names):
        assert np.array_equal(ours[n].detach().numpy(), np.asarray(ref[n])), n
    s1, s2 = leaf_scales(g1, names), leaf_scales(g2, names)
    worst, held, total = 0.0, 0, 0
    for n in names:
        sure = ((np.abs(np.asarray(g1[n])) > 10 * rel * s1[n])
                & (np.abs(np.asarray(g2[n])) > 10 * rel * s2[n]))
        d = np.abs(ours[n].detach().numpy() - np.asarray(ref[n]))
        held, total = held + int(sure.sum()), total + d.size
        if sure.any():
            worst = max(worst, float(d[sure].max()))
    print(f"after two steps: {total - held} of {total} elements left out (a gradient "
          f"within {10 * rel} of its leaf's scale of 0); the rest within "
          f"{worst / lr:.3e} * lr of JAX's")
    assert worst <= 1e-2 * lr, (worst, lr)
    assert held >= 0.95 * total, (held, total)


def assert_metrics_match(ours: dict, ref: dict, rel: float = 1e-5):
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=rel, atol=0, err_msg=k)
