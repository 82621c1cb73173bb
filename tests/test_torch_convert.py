"""Weight bridge and import isolation of the PyTorch port."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import torch

from pgtformer_tpu.convert.torch_port import export_torch_state_dict
from pgtformer_tpu_torch.convert import flax_to_state_dict, load_checkpoint, load_into
from pgtformer_tpu_torch.models.pgtformer import PGTFormer
from tests.test_torch_common import small_configs, small_pgt  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pgtformer_tpu_torch"


def test_flax_to_state_dict_matches_export(small_pgt):
    _, v, _, _ = small_pgt
    ours = flax_to_state_dict(v)
    ref = export_torch_state_dict(v)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


def test_port_state_dict_has_reference_keys(small_pgt):
    """strict load works (the fixture did it) and the port's persistent
    state is exactly the exported key set: no num_batches_tracked, and
    relative_position_index is a non-persistent buffer."""
    _, v, model, _ = small_pgt
    assert set(model.state_dict()) == set(flax_to_state_dict(v))
    for name, buf in model.named_buffers():
        if name.endswith("relative_position_index"):
            assert name not in model.state_dict()
    for key in ("encoder.down.1.attn.0.blocks.1.attn.q.weight",
                "fuse_convs_dict.32.encode_enc.conv_out.weight",
                "ft_layers.0.self_attn.in_proj_weight", "idx_pred_layer.1.weight",
                "quantizer.codebooks.0.weight"):
        assert key in model.state_dict()


def test_load_into_ignores_derived_buffers(small_pgt):
    _, v, model, _ = small_pgt
    _, tc = small_configs()
    sd = dict(flax_to_state_dict(v))
    sd["conditionnet.cp.resnet.bn1.num_batches_tracked"] = np.zeros((), np.int64)
    sd["encoder.mid.attn_1.blocks.0.attn.relative_position_index"] = np.zeros((48, 48), np.int64)
    fresh = load_into(PGTFormer(tc), sd)
    for k, val in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], val, rtol=0, atol=0)
    sd["encoder.conv_in.extra"] = np.zeros(1, np.float32)
    with pytest.raises(RuntimeError, match="extra"):
        load_into(fresh, sd)


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_checkpoint(small_pgt, tmp_path, fmt):
    _, v, _, _ = small_pgt
    sd = {k: torch.from_numpy(a) for k, a in flax_to_state_dict(v).items()}
    path = str(tmp_path / f"w.{fmt}")
    if fmt == "pth":
        torch.save({"params_ema": sd}, path)
    else:
        from safetensors.torch import save_file
        save_file(sd, path)
    loaded = load_checkpoint(path)
    assert loaded.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)


def _port_modules():
    """Every module of the port, by its dotted name (a walk of the package)."""
    mods = []
    for f in PORT.rglob("*.py"):
        parts = f.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if f.name == "__init__.py" else parts))
    return sorted(mods)


def test_import_with_jax_blocked():
    """Every module of the package imports with jax, flax and pgtformer_tpu
    absent."""
    mods = _port_modules()
    for new in ("pgtformer_tpu_torch.train_cli", "pgtformer_tpu_torch.registry",
                "pgtformer_tpu_torch.train.trainer", "pgtformer_tpu_torch.train.validate",
                "pgtformer_tpu_torch.utils.checkpoint", "pgtformer_tpu_torch.utils.logging",
                "pgtformer_tpu_torch.utils.img", "pgtformer_tpu_torch.data.vfhq",
                "pgtformer_tpu_torch.data.loader", "pgtformer_tpu_torch.data.degradations",
                "pgtformer_tpu_torch.data.align", "pgtformer_tpu_torch.eval.metrics",
                "pgtformer_tpu_torch.train.stages", "pgtformer_tpu_torch.cli",
                "pgtformer_tpu_torch.eval_cli", "pgtformer_tpu_torch.eval.niqe",
                "pgtformer_tpu_torch.eval.landmarks", "pgtformer_tpu_torch.eval.arcface",
                "pgtformer_tpu_torch.io.native", "pgtformer_tpu_torch.io.video",
                "pgtformer_tpu_torch.utils.profiling", "pgtformer_tpu_torch.eval.vmaf",
                "pgtformer_tpu_torch.profile_stages", "pgtformer_tpu_torch.bench_encode"):
        assert new in mods
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'pgtformer_tpu'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'flax', 'orbax', 'pgtformer_tpu.'))\n"
            "               for k in sys.modules if sys.modules[k] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_package_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("knobs.py", "ops/vq.py", "models/vae.py", "models/quantizer.py",
                "models/vqgan.py", "ops/autograd.py", "train/stages.py", "train/lpips.py", "train/losses.py",
                "train/schedule.py", "train/ema.py", "train/state.py", "train_cli.py",
                "registry.py", "train/trainer.py", "train/validate.py", "utils/checkpoint.py",
                "utils/logging.py", "utils/img.py", "data/vfhq.py", "data/loader.py",
                "data/degradations.py", "data/align.py", "eval/metrics.py", "eval_cli.py",
                "eval/niqe.py", "eval/landmarks.py", "eval/arcface.py", "io/native.py",
                "io/video.py", "utils/profiling.py", "eval/vmaf.py", "profile_stages.py",
                "bench_encode.py"):
        assert PORT / new in files
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "orbax", "pgtformer_tpu"), (f, mod)
