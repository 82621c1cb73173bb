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
