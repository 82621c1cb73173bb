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
                "pgtformer_tpu_torch.profile_stages", "pgtformer_tpu_torch.bench_encode",
                "pgtformer_tpu_torch.parallel", "pgtformer_tpu_torch.parallel.group",
                "pgtformer_tpu_torch.nn.misc", "pgtformer_tpu_torch.nn.swin3d",
                "pgtformer_tpu_torch.models.rqvae", "pgtformer_tpu_torch.models.tdrqvae",
                "pgtformer_tpu_torch.models.codeformer"):
        assert new in mods
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'orbax', 'pgtformer_tpu'):\n"
            "    sys.modules[m] = None\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            "import tests.torch_parallel_workers\n"
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
    """The port, chip_smoke.py and the rank functions that the parallel
    tests spawn (tests/torch_parallel_workers.py) import no JAX."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "tests" / "torch_parallel_workers.py"]
    assert len(files) > 10
    for new in ("knobs.py", "ops/vq.py", "models/vae.py", "models/quantizer.py",
                "models/vqgan.py", "ops/autograd.py", "train/stages.py", "train/lpips.py", "train/losses.py",
                "train/schedule.py", "train/ema.py", "train/state.py", "train_cli.py",
                "registry.py", "train/trainer.py", "train/validate.py", "utils/checkpoint.py",
                "utils/logging.py", "utils/img.py", "data/vfhq.py", "data/loader.py",
                "data/degradations.py", "data/align.py", "eval/metrics.py", "eval_cli.py",
                "eval/niqe.py", "eval/landmarks.py", "eval/arcface.py", "io/native.py",
                "io/video.py", "utils/profiling.py", "eval/vmaf.py", "profile_stages.py",
                "bench_encode.py", "parallel/__init__.py", "parallel/group.py",
                "nn/misc.py", "nn/swin3d.py", "models/rqvae.py", "models/tdrqvae.py",
                "models/codeformer.py"):
        assert PORT / new in files
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "orbax", "pgtformer_tpu"), (f, mod)


# -- the secondary architectures -------------------------------------------------

def _secondary(name):
    """(JAX module, port module, JAX init arguments) of each new tree, at
    small widths but for CodeFormer (its fuse blocks' channels are fixed to
    the 512 layout; only shapes are traced)."""
    import jax.numpy as jnp
    import pgtformer_tpu.config as jc
    import pgtformer_tpu.models.codeformer as jcf
    import pgtformer_tpu.models.rqvae as jrq
    import pgtformer_tpu.models.tdrqvae as jtd
    import pgtformer_tpu.models.vqgan as jvq
    import pgtformer_tpu.nn.blocks as jb
    import pgtformer_tpu.nn.misc as jmisc
    import pgtformer_tpu.nn.swin3d as js
    import pgtformer_tpu.nn.transformer as jtr
    import pgtformer_tpu_torch.config as tc
    from pgtformer_tpu_torch.models import codeformer, rqvae, tdrqvae, vqgan
    from pgtformer_tpu_torch.nn import blocks, misc, swin3d, transformer
    dd = dict(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              attn_resolutions=(16,), stages_atten=2, window_size=(2, 4, 4), num_head=4)
    vq = dict(embed_dim=32, n_embed=64, latent_shape=(16, 16, 32), code_shape=(16, 16, 1))
    jcfg = jc.VQVAEConfig(ddconfig=jc.DDConfig(**dd), **vq)
    tcfg = tc.VQVAEConfig(ddconfig=tc.DDConfig(**dd), **vq)
    ae = dict(img_size=32, nf=32, ch_mult=(1, 2), res_blocks=1, attn_resolutions=(16,),
              codebook_size=64, emb_dim=32)
    z = jnp.zeros
    js.compute_mask_3d(4, 16, 16, (2, 4, 4), (1, 2, 2))     # eval_shape traces the mask
    js.compute_mask_3d(2, 4, 4, (2, 2, 2), (0, 1, 1))
    return {
        "RQVAE": (jrq.RQVAE(jcfg), lambda: rqvae.RQVAE(tcfg), (z((1, 32, 32, 3)),)),
        "TDRQVAE": (jtd.TDRQVAE(jcfg), lambda: tdrqvae.TDRQVAE(tcfg), (z((1, 3, 32, 32, 3)),)),
        "VQAutoEncoder": (jvq.VQAutoEncoder(**ae), lambda: vqgan.VQAutoEncoder(**ae),
                          (z((1, 32, 32, 3)),)),
        "VQAutoEncoder-gumbel": (jvq.VQAutoEncoder(quantizer="gumbel", **ae),
                                 lambda: vqgan.VQAutoEncoder(quantizer="gumbel", **ae),
                                 (z((1, 32, 32, 3)),)),
        "CodeFormer": (jcf.CodeFormer(w=1.0), lambda: codeformer.CodeFormer(),
                       (z((1, 512, 512, 3)),)),
        "DecoderLayer": (jb.DecoderLayer(dim=32, depth=2, num_heads=4, num_frames=3,
                                         window_size=(4, 4)),
                         lambda: blocks.DecoderLayer(32, 2, 4, 3, (4, 4)),
                         (z((1, 3, 8, 8, 32)), z((1, 3, 8, 8, 32)))),
        "TransformerCALayer": (jtr.TransformerCALayer(32, 4, 64),
                               lambda: transformer.TransformerCALayer(32, 4, 64),
                               (z((1, 8, 32)), z((1, 8, 32)))),
        "TransposedUpsample": (jmisc.TransposedUpsample(8), lambda: misc.TransposedUpsample(4, 8),
                               (z((1, 2, 4, 4, 4)),)),
        "SwinTransformer3D": (js.SwinTransformer3D(embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                                                   window_size=(2, 2, 2)),
                              lambda: swin3d.SwinTransformer3D(
                                  embed_dim=16, depths=(2, 2), num_heads=(2, 4),
                                  window_size=(2, 2, 2), input_size=(4, 16, 16)),
                              (z((1, 4, 16, 16, 3)),)),
    }[name]


SECONDARY = ["RQVAE", "TDRQVAE", "VQAutoEncoder", "VQAutoEncoder-gumbel", "CodeFormer",
             "DecoderLayer", "TransformerCALayer", "TransposedUpsample", "SwinTransformer3D"]
# leaves the weight bridge must carry across for each tree
SECONDARY_KEYS = {
    "VQAutoEncoder": ("encoder.blocks.2.conv.weight", "generator.blocks.6.conv.weight",
                      "quantize.embedding.weight", "encoder.blocks.3.conv_out.weight"),
    "VQAutoEncoder-gumbel": ("quantize.embed.weight", "quantize.proj.weight"),
    "CodeFormer": ("position_emb", "fuse_convs_dict.32.encode_enc.conv_out.weight",
                   "fuse_convs_dict.256.scale.2.bias", "idx_pred_layer.1.weight",
                   "ft_layers.8.self_attn.in_proj_weight", "quantize.embedding.weight"),
    "TDRQVAE": ("tdswin_pre.blocks.1.mlp_fc1.weight",
                "tdswin_post.blocks.0.attn.relative_position_bias_table",
                "quantizer.codebooks.0.embed_ema"),
    "DecoderLayer": ("blocks.0.attn.q.weight", "blocks.1.attn2.kv.weight",
                     "blocks.0.norm_kv.weight", "blocks.1.norm3.bias"),
    "TransposedUpsample": ("deconv.weight",),
    "SwinTransformer3D": ("patch_embed.proj.weight", "layers_0.downsample.reduction.weight"),
}


@pytest.mark.parametrize("name", SECONDARY)
def test_secondary_state_dicts_are_the_exported_ones(name):
    """flax_to_state_dict equals the JAX package's exporter on each new
    tree, and the port's module loads it strictly, unchanged."""
    from tests.test_torch_common import random_variables
    jm, make, args = _secondary(name)
    v = random_variables(jm, *args)
    ours, ref = flax_to_state_dict(v), export_torch_state_dict(v)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    for k in SECONDARY_KEYS.get(name, ()):
        assert k in ours, k
    port = make()
    port.load_state_dict({k: torch.from_numpy(a) for k, a in ours.items()}, strict=True)
    assert set(port.state_dict()) == set(ours)


def test_arch_registry_matches_jax_and_builds_each():
    """The port's ARCH_REGISTRY holds the JAX package's seven names, and
    each entry builds by name."""
    import importlib
    from pgtformer_tpu.registry import ARCH_REGISTRY as JAX_REGISTRY
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    from pgtformer_tpu_torch.registry import ARCH_REGISTRY
    for m in ("vae", "pgtformer", "rqvae", "tdrqvae", "codeformer", "vqgan"):
        importlib.import_module(f"pgtformer_tpu.models.{m}")
    assert set(ARCH_REGISTRY.keys()) == set(JAX_REGISTRY.keys())
    assert len(ARCH_REGISTRY.keys()) == 7 and "RQVAE" in ARCH_REGISTRY
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,),
                  stages_atten=2, window_size=(2, 4, 4), num_head=4)
    vq = VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64, latent_shape=(16, 16, 32),
                     code_shape=(16, 16, 1))
    args = {"TDCRQVAE3": (vq,), "RQVAE": (vq,), "TDRQVAE": (vq,),
            "PGTFormer": (PGTFormerConfig(vqvae=vq, dim_embd=64, n_head=4, n_layers=1,
                                          connect_list=("16",)),),
            "VQAutoEncoder": (), "CodeFormer": (), "VQGANDiscriminator": ()}
    kw = {"VQAutoEncoder": dict(img_size=32, nf=32, ch_mult=(1, 2), res_blocks=1,
                                attn_resolutions=(16,), codebook_size=64, emb_dim=32),
          "CodeFormer": dict(img_size=64, nf=32, ch_mult=(1, 2), res_blocks=1,
                             attn_resolutions=(32,), codebook_size=64, emb_dim=32,
                             dim_embd=32, n_head=4, n_layers=1, latent_size=1024,
                             connect_list=()),
          "VQGANDiscriminator": dict(ndf=16, n_layers=2)}
    for name in ARCH_REGISTRY.keys():
        model = ARCH_REGISTRY.get(name)(*args[name], **kw.get(name, {}))
        assert type(model).__name__ == name
        assert sum(p.numel() for p in model.parameters()) > 0
    with pytest.raises(KeyError, match="not found"):
        ARCH_REGISTRY.get("NoSuchArch")
