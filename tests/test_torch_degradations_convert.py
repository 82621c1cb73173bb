"""The batched on-device noise of ``data/degradations.py`` and the
checkpoint surface of ``convert.py`` in the PyTorch port, on the CPU
against the JAX package.

* Batch degradations: torch's draws are not `jax.random`'s, so they are
  held by what is deterministic (the 256-level occupancy, Poisson's `vals`,
  the clip/round finish, sigma = 0 and scale = 0: equal to JAX's bit for
  bit), by the noise's per-sample moments against the JAX function's on the
  same image (standard deviation within 3%, Poisson variance within 5%,
  n = 12,288 values a sample), and by determinism per generator seed.
* `.safetensors` read and written by the port itself: each side reads the
  other's files (the `safetensors` package here, which the card's machine
  lacks) with tensors, dtypes and shapes exact; `load_checkpoint` and
  `read_export` need no package.
* `save_reference_checkpoint`, `port_subtree`, `from_pretrained` (a local
  file or directory) and `push_to_hub(dry_run=True)` against the JAX
  package's functions of the same names on the same weights.
"""

import copy
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.convert.torch_port as jport
import pgtformer_tpu.data.degradations as jdeg
from pgtformer_tpu.models.parser import BiSeNet as JaxBiSeNet
from pgtformer_tpu.models.pgtformer import PGTFormer as JaxPGTFormer
from pgtformer_tpu_torch import convert
from pgtformer_tpu_torch.data import degradations as deg
from pgtformer_tpu_torch.models.pgtformer import PGTFormer
from pgtformer_tpu_torch.utils.checkpoint import read_export
from tests.test_torch_common import (  # noqa: F401
    one_torch_thread, random_variables, small_configs, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(23)


def _img(B=2, H=64, W=64):
    """[B, H, W, 3] in [0, 1]: sample 0 on 6 gray levels, the others smooth."""
    img = RNG.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    img[0] = np.round(img[0] * 5) / 5
    return img


# -- batch degradations --------------------------------------------------------------

def test_levels_and_vals_match_jax():
    img = _img(3)
    img[2] = 0.5                                        # one level: vals clamps to 2
    q = np.clip(np.round(img * 255.0), 0, 255)
    ours = deg._unique_levels_batch(torch.from_numpy(q))
    ref = np.asarray(jdeg._unique_levels_batch(jnp.asarray(q)))
    assert ours.tolist() == ref.tolist() == [6, ref[1], 1] and ref[1] > 200
    vals = deg._poisson_vals_batch(torch.from_numpy(q))
    assert vals.dtype == torch.float32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jdeg._poisson_vals_batch(jnp.asarray(q))))


@pytest.mark.parametrize("clip,rounds", [(True, True), (True, False), (False, True),
                                         (False, False)])
def test_finish_matches_jax(clip, rounds):
    img = _img()
    noise = (RNG.normal(size=img.shape) * 0.2).astype(np.float32)
    ours = deg._finish_batch(torch.from_numpy(img), torch.from_numpy(noise), clip, rounds)
    ref = np.asarray(jdeg._finish_jnp(jnp.asarray(img), jnp.asarray(noise), clip, rounds))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("rounds", [False, True])
def test_zero_sigma_and_scale_match_jax(rounds):
    """sigma = 0 and scale = 0 leave only the finish, with per-sample gray
    flags: JAX's result bit for bit."""
    img = _img()
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    gray = np.array([0.0, 1.0], np.float32)
    ours = deg.add_gaussian_noise_batch(torch.from_numpy(img), g, 0.0, torch.from_numpy(gray),
                                        rounds=rounds)
    ref = jdeg.add_gaussian_noise_batch(jnp.asarray(img), key, 0.0, jnp.asarray(gray),
                                        rounds=rounds)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ours = deg.add_poisson_noise_batch(torch.from_numpy(img), g, np.zeros(2, np.float32),
                                       torch.from_numpy(gray), rounds=rounds)
    ref = jdeg.add_poisson_noise_batch(jnp.asarray(img), key, jnp.zeros(2), jnp.asarray(gray),
                                       rounds=rounds)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _per_sample(noise):
    n = noise.reshape(noise.shape[0], -1).astype(np.float64)
    return n.mean(1), n.std(1)


def test_gaussian_moments_match_jax():
    """Per-sample sigma 5 and 20 (0-255 scale), color and gray noise."""
    img = _img()
    sigma, gray = np.array([5.0, 20.0], np.float32), np.array([0.0, 1.0], np.float32)
    ours = deg.add_gaussian_noise_batch(torch.from_numpy(img), torch.Generator().manual_seed(1),
                                        torch.from_numpy(sigma), torch.from_numpy(gray),
                                        clip=False).numpy() - img
    ref = np.asarray(jdeg.add_gaussian_noise_batch(jnp.asarray(img), jax.random.PRNGKey(1),
                                                   jnp.asarray(sigma), jnp.asarray(gray),
                                                   clip=False)) - img
    (m, s), (mr, sr) = _per_sample(ours), _per_sample(ref)
    np.testing.assert_allclose(s, sr, rtol=3e-2)
    np.testing.assert_allclose(s, sigma / 255.0, rtol=3e-2)
    bound = 4 * s / np.sqrt(img[0, ..., 0].size)      # the gray field: one value a pixel
    assert np.all(np.abs(m) < bound) and np.all(np.abs(mr) < 4 * sr / np.sqrt(img[0, ..., 0].size))
    # gray noise is one field for the three channels
    assert np.allclose(ours[1, ..., 0], ours[1, ..., 2], rtol=0, atol=1e-6)   # img + n - img
    assert not np.allclose(ours[0, ..., 0], ours[0, ..., 2], rtol=0, atol=1e-6)


def test_poisson_moments_match_jax():
    """Per-sample scale 1 and 0.5, color and gray noise: variance against
    JAX's and against its expectation mean(q/255) / vals * scale^2."""
    img = _img()
    scale, gray = np.array([1.0, 0.5], np.float32), np.array([0.0, 1.0], np.float32)
    ours = deg.add_poisson_noise_batch(torch.from_numpy(img), torch.Generator().manual_seed(2),
                                       torch.from_numpy(scale), torch.from_numpy(gray),
                                       clip=False).numpy() - img
    ref = np.asarray(jdeg.add_poisson_noise_batch(jnp.asarray(img), jax.random.PRNGKey(2),
                                                  jnp.asarray(scale), jnp.asarray(gray),
                                                  clip=False)) - img
    (_, s), (_, sr) = _per_sample(ours), _per_sample(ref)
    np.testing.assert_allclose(s ** 2, sr ** 2, rtol=5e-2)
    q0 = np.clip(np.round(img[0] * 255.0), 0, 255) / 255.0
    vals0 = float(jdeg._poisson_vals_batch(jnp.asarray(np.round(img[:1] * 255.0)))[0])
    np.testing.assert_allclose(s[0] ** 2, q0.mean() / vals0, rtol=5e-2)


def test_batch_noise_is_deterministic_per_seed():
    img = torch.from_numpy(_img())
    for fn, kw in ((deg.random_add_gaussian_noise_batch, dict(sigma_range=(1, 30), gray_prob=0.5)),
                   (deg.random_add_poisson_noise_batch, dict(scale_range=(0.5, 2), gray_prob=0.5))):
        a = fn(img, torch.Generator().manual_seed(3), **kw)
        b = fn(img, torch.Generator().manual_seed(3), **kw)
        c = fn(img, torch.Generator().manual_seed(4), **kw)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert a.shape == img.shape and a.dtype == torch.float32
        assert 0 <= a.min() and a.max() <= 1


# -- .safetensors --------------------------------------------------------------------

def _tensors():
    return {"w": torch.randn(3, 4), "h": torch.randn(2, 5).half(),
            "b": torch.randn(7).to(torch.bfloat16), "i": torch.arange(6).reshape(2, 3),
            "i32": torch.arange(4, dtype=torch.int32), "u": torch.arange(9, dtype=torch.uint8),
            "m": torch.tensor([True, False, True]), "s": torch.tensor(2.5),
            "e": torch.zeros(0, 3), "d": torch.randn(2, 2, dtype=torch.float64)}


def _same(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        x, y = torch.as_tensor(a[k]), torch.as_tensor(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), k


def test_safetensors_written_here_read_by_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file
    src = _tensors()
    convert.save_safetensors(src, str(tmp_path / "a.safetensors"))
    _same(load_file(str(tmp_path / "a.safetensors")), src)
    got = np_load(str(tmp_path / "a.safetensors"))          # numpy has no bf16
    _same({k: torch.from_numpy(v) for k, v in got.items() if k != "b"},
          {k: v for k, v in src.items() if k != "b"})
    convert.save_safetensors({k: v.numpy() for k, v in src.items() if k != "b"},
                             str(tmp_path / "n.safetensors"))
    _same(load_file(str(tmp_path / "n.safetensors")), {k: v for k, v in src.items() if k != "b"})


def test_safetensors_written_by_the_package_read_here(tmp_path):
    from safetensors.torch import save_file
    src = _tensors()
    save_file(src, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    _same(convert.load_safetensors(str(tmp_path / "a.safetensors")), src)


def test_checkpoint_readers_need_no_package(tmp_path, monkeypatch):
    sd = {"conv.weight": torch.randn(4, 3, 3, 3), "conv.bias": torch.randn(4)}
    path = str(tmp_path / "net_g_1.safetensors")
    convert.save_safetensors(sd, path)
    for name in [m for m in sys.modules if m == "safetensors" or m.startswith("safetensors.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    _same(convert.load_checkpoint(path), sd)
    _same(read_export(path), sd)
    with pytest.raises(ValueError):
        with open(path, "r+b") as f:               # a header length past the end
            f.write((10 ** 9).to_bytes(8, "little"))
        convert.load_safetensors(path)


# -- the checkpoint surface ---------------------------------------------------------

@pytest.fixture(scope="module")
def small_model():
    """(JAX config, port config, JAX variables, port PGTFormer) with the
    same seeded weights."""
    jc, tc = small_configs()
    x = np.random.default_rng(24).uniform(0, 1, (1, 3, 32, 32, 3)).astype(np.float32)
    v = random_variables(JaxPGTFormer(jc), jnp.asarray(x), seed=25, w=1.0)
    return jc, tc, v, to_port(PGTFormer(tc), v)


def _jax_sd(variables):
    return {k: torch.from_numpy(np.array(v))
            for k, v in jport.export_torch_state_dict(variables).items()}


@pytest.mark.parametrize("ext", ["safetensors", "pth"])
def test_save_reference_checkpoint_matches_jax(small_model, tmp_path, ext):
    _, _, v, model = small_model
    ours, theirs = str(tmp_path / f"ours.{ext}"), str(tmp_path / f"jax.{ext}")
    convert.save_reference_checkpoint(model, ours)
    jport.save_reference_checkpoint(v, theirs)
    ref = _jax_sd(v)
    _same(jport.load_torch_checkpoint(ours), {k: t.numpy() for k, t in ref.items()})
    _same(convert.load_checkpoint(theirs), ref)
    if ext == "pth":
        assert set(torch.load(ours, weights_only=True)) == {"params_ema"}


def test_port_subtree_matches_jax(small_model):
    """A standalone BiSeNet state dict into `conditionnet`, strict."""
    jc, tc, v, model = small_model
    model = copy.deepcopy(model)
    x = np.zeros((1, 32, 32, 3), np.float32)
    out_hw = (16, 16)
    bis = random_variables(JaxBiSeNet(jc.n_parsing_classes, out_hw=out_hw), jnp.asarray(x),
                           seed=26)
    sd = convert.flax_to_state_dict(bis)
    sub = {col: {"conditionnet": tree["conditionnet"]} for col, tree in v.items()
           if "conditionnet" in tree}
    jnew = jport.port_subtree(sub, "conditionnet", sd)
    ref = {k[len("conditionnet."):]: t
           for k, t in _jax_sd(jnew).items() if k.startswith("conditionnet.")}
    before = {k: t.clone() for k, t in model.state_dict().items()
              if not k.startswith("conditionnet.")}
    convert.port_subtree(model, "conditionnet", sd)
    _same({k: t for k, t in model.conditionnet.state_dict().items() if k in ref}, ref)
    _same({k: t for k, t in model.state_dict().items() if not k.startswith("conditionnet.")},
          before)
    with pytest.raises(RuntimeError):
        convert.port_subtree(model, "conditionnet", {k: sd[k] for k in list(sd)[1:]})
    convert.port_subtree(model, "conditionnet", {"no.such.key": np.zeros(1)}, strict=False)
    _same({k: t for k, t in model.conditionnet.state_dict().items() if k in ref}, ref)


def test_from_pretrained_local_directory_matches_jax(small_model, tmp_path):
    """A directory with model.safetensors (written here, read by JAX's
    loader too), one with pytorch_model.bin, and the file itself."""
    jc, tc, v, model = small_model
    st, bin_dir = tmp_path / "st", tmp_path / "bin"
    st.mkdir(), bin_dir.mkdir()
    convert.save_reference_checkpoint(model, str(st / "model.safetensors"))
    torch.save(model.state_dict(), str(bin_dir / "pytorch_model.bin"))
    ours = convert.from_pretrained(str(st), cfg=tc, dtype=torch.float32, device="cpu")
    assert isinstance(ours, PGTFormer) and not ours.training
    assert not any(getattr(m, "use_pallas", False) for m in ours.modules())
    _, jvars = jport.from_pretrained(str(st), cfg=jc, dtype=jnp.float32)
    ref = _jax_sd(jvars)
    _same({k: t for k, t in ours.state_dict().items() if k in ref}, ref)
    for path in (bin_dir, st / "model.safetensors"):
        again = convert.from_pretrained(str(path), cfg=tc, dtype=torch.float32, device="cpu")
        _same(again.state_dict(), ours.state_dict())
    half = convert.from_pretrained(str(st), cfg=tc, device="cpu")      # bf16 by default
    assert half.quant_conv.weight.dtype == torch.bfloat16


def test_from_pretrained_takes_no_hub_id(tmp_path):
    with pytest.raises(FileNotFoundError, match="network"):
        convert.from_pretrained("kepeng/pgtformer-base", device="cpu")
    with pytest.raises(FileNotFoundError, match="holds neither"):
        convert.local_checkpoint(str(tmp_path))
    (tmp_path / "pytorch_model.bin").write_bytes(b"")
    (tmp_path / "model.safetensors").write_bytes(b"")
    assert convert.local_checkpoint(str(tmp_path)) == str(tmp_path / "model.safetensors")


def test_push_to_hub_dry_run_stages_as_jax(small_model, tmp_path):
    jc, tc, v, model = small_model
    ours = convert.push_to_hub(model, "me/pgt", staging_dir=str(tmp_path / "ours"), cfg=tc,
                               dry_run=True)
    theirs = jport.push_to_hub(v, "me/pgt", staging_dir=str(tmp_path / "jax"), cfg=jc,
                               dry_run=True)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == ["config.json",
                                                                       "pytorch_model.bin"]
    _same(torch.load(os.path.join(ours, "pytorch_model.bin"), weights_only=True),
          torch.load(os.path.join(theirs, "pytorch_model.bin"), weights_only=True))
