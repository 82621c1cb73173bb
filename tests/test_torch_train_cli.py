"""The port's training CLI against the JAX package's, and its runs on the CPU.

- `detect_stage` gives the JAX package's answer (or refusal) on every case
  of `tests/test_train_cli.py::test_detect_stage`;
- `build_from_options` on each YAML of `configs/` gives the same StageHyper
  and model config as the JAX package's, field by field;
- `train_cli.main --device cpu` runs stages I–IV for 2 steps each from
  small YAMLs derived from `configs/demo_stage_*.yml`, chained through the
  exports, with validation, checkpoints and exports where the YAML says;
- resume is exact: in fp32, N steps in one run and k steps followed by a
  resume to N give bit-identical training states (parameters, EMA,
  codebooks, optimizer and scheduler state, discriminator statistics, the
  random generator, the loader's position) and exports, for stages I and III.
"""

import copy
import dataclasses
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

from pgtformer_tpu_torch import train_cli as T
from tests.test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (options, path) of tests/test_train_cli.py::test_detect_stage
DETECT_CASES = [
    ({}, "release_train_stage_I_need_align_version.yml"),
    ({}, "release_train_stage_II_need_align_version.yml"),
    ({}, "release_train_stage_III__need_align_version.yml"),
    ({}, "release_train_stage_IIII_dont_need_align_version.yml"),
    ({}, "configs/demo_stage_I.yml"),
    ({}, "configs/demo_stage_II.yml"),
    ({}, "configs/demo_stage_III.yml"),
    ({}, "configs/demo_stage_IV.yml"),
    ({}, "exp/stage_II_sweeps/release_train_stage_I_need_align_version.yml"),
    ({}, "/data/stage_IV/demo_no_hints.yml"),
    ({"stage": "II"}, "whatever.yml"),
    ({"stage": 4}, "demo_stage_I.yml"),
    ({"model_type": "TRQVAEModel"}, "x.yml"),
    ({"model_type": "TRQCodeFormerModel", "code_only": True}, "x.yml"),
    ({"model_type": "TRQCodeFormerModel"}, "x.yml"),
    ({"stage": "V"}, "x.yml"),
]


def _answer(fn, opt, path):
    try:
        return fn(opt, path)
    except SystemExit:
        return SystemExit


@pytest.mark.parametrize("opt,path", DETECT_CASES, ids=[f"{i}" for i in range(len(DETECT_CASES))])
def test_detect_stage_matches_jax(opt, path):
    from pgtformer_tpu.train_cli import detect_stage as jdetect
    assert _answer(T.detect_stage, opt, path) == _answer(jdetect, opt, path)


CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yml")))


@pytest.mark.parametrize("name", CONFIGS)
def test_build_from_options_matches_jax(name):
    """StageHyper and model config field by field (the port's modules are
    built on the meta device: only their configuration is compared)."""
    from pgtformer_tpu.config import load_options as jload
    from pgtformer_tpu.train_cli import build_from_options as jbuild
    from pgtformer_tpu_torch.config import load_options
    path = os.path.join(REPO, "configs", name)
    opt = load_options(path)
    assert opt == jload(path)
    stage = T.detect_stage(opt, path)
    j_tr, j_hp = jbuild(jload(path), stage, "")
    with torch.device("meta"):
        tr, hp = T.build_from_options(opt, stage, "", device="cpu")
    assert dataclasses.asdict(hp) == dataclasses.asdict(j_hp)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(j_tr.cfg)
    assert type(tr).__name__ == type(j_tr).__name__
    if stage != "I":
        assert tr.stage == j_tr.stage and tr.frozen_modules() == [
            m for m in j_tr.cfg.fix_modules if m != "quantizer"] + (
            ["post_quant_conv"] if "decoder" in j_tr.cfg.fix_modules else [])


# -- runs ----------------------------------------------------------------------

_VQ = dict(embed_dim=32, n_embed=64, latent_shape=[16, 16, 32], code_shape=[16, 16, 1],
           checkpointing=False)
_DD = dict(z_channels=32, resolution=32, ch=32, ch_mult=[1, 2], depths=[2, 2],
           num_heads=[4, 4], window_sizes=[[4, 4], [4, 4]], attn_resolutions=[16])


def tiny_options(stage: str) -> dict:
    """configs/demo_stage_<stage>.yml at the small test geometry: 32x32
    frames, a 2-level autoencoder, 2 code-transformer layers of width 64, a
    2-layer discriminator; batch 2, print every step, save and validate
    every 2, a 2-step warm-up and a milestone at 3; TensorBoard off."""
    with open(os.path.join(REPO, "configs", f"demo_stage_{stage}.yml")) as f:
        opt = yaml.safe_load(f)
    g = copy.deepcopy(opt["network_g"])
    g.update(_VQ)
    g["ddconfig"] = {**g["ddconfig"], **_DD}
    if stage != "I":
        g.update(dim_embd=64, n_head=4, n_layers=2, connect_list=["16", "32"])
        opt["network_gt"] = {**copy.deepcopy(opt["network_gt"]), **_VQ,
                             "ddconfig": dict(g["ddconfig"])}
    opt["network_g"] = g
    opt["network_d"] = {"type": "VQGANDiscriminator", "ndf": 16, "n_layers": 2}
    opt["datasets"]["train"].update(batch_size_per_gpu=2, num_worker_per_gpu=2)
    opt["train"].update(warmup_iter=2, scheduler={"type": "MultiStepLR", "milestones": [3],
                                                  "gamma": 0.5})
    opt["val"]["val_freq"] = 2
    opt["logger"] = {"print_freq": 1, "save_checkpoint_freq": 2, "use_tb_logger": False}
    return opt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A seeded VFHQ tree (train: 2 clips x 3 frames, val: 1 clip x 3 frames,
    32x32 PNGs), the four small YAMLs, and a runner of train_cli.main."""
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    for split, clips in (("train", 2), ("val", 1)):
        for c in range(clips):
            d = root / "vfhq" / split / "GT" / f"clip_{c}"
            os.makedirs(d)
            for i in range(3):
                cv2.imwrite(str(d / f"{i:08d}.png"),
                            rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    for stage in ("I", "II", "III", "IV"):
        (root / f"tiny_stage_{stage}.yml").write_text(yaml.safe_dump(tiny_options(stage)))

    def run(stage, exp, *extra):
        return T.main(["-opt", str(root / f"tiny_stage_{stage}.yml"),
                       "--data-root", str(root / "vfhq" / "train"),
                       "--val-data-root", str(root / "vfhq" / "val"), "--val-samples", "2",
                       "--exp-dir", str(root / "exp" / exp), "--device", "cpu", *extra])

    return root, run


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


METRIC_KEYS = {
    "I": {"l_pix", "l_percep", "l_quant", "l_g_gan", "l_g_total", "l_d"},
    "II": {"l_token", "l_feat", "l_g_total"},
    "III": {"l_token", "l_feat", "l_pix", "l_percep", "l_g_gan", "l_g_total", "l_d"},
    "IV": {"l_token", "l_feat", "l_pix", "l_percep", "l_g_gan", "l_g_total", "l_d"},
}


def test_train_cli_stages_chained_on_the_cpu(runs):
    """Stages I–IV, 2 steps each (LPIPS on its random VGG), each later stage
    from the previous stage's exports: metrics every step, a checkpoint,
    exports and a validation at step 2."""
    root, run = runs
    prev = None
    for stage in ("I", "II", "III", "IV"):
        extra = ["--total-iter", "2"]
        if stage != "I":
            extra += ["--teacher-ckpt", str(root / "exp" / "chain_I" / "net_g_2.pth"),
                      "--student-ckpt", str(root / "exp" / f"chain_{prev}" / "net_g_2.pth")]
            if stage in ("III", "IV"):
                extra += ["--disc-ckpt", str(root / "exp" / "chain_I" / "net_d_2.pth")]
        assert run(stage, f"chain_{stage}", *extra) == 0
        exp = root / "exp" / f"chain_{stage}"
        lines = _jsonl(exp / "metrics.jsonl")
        steps = [r for r in lines if "it_per_s" in r]
        assert [r["step"] for r in steps] == [1, 2]
        for r in steps:
            assert set(r) == {"step", "it_per_s"} | METRIC_KEYS[stage]
            assert all(np.isfinite(v) for v in r.values())
        val = [r for r in lines if "val/psnr" in r]
        assert [r["step"] for r in val] == [2] and set(val[0]) == {"step", "val/psnr", "val/ssim"}
        assert sorted(os.listdir(exp / "state")) == ["2.pth"]
        assert (exp / "net_g_2.pth").exists()
        assert (exp / "net_d_2.pth").exists() == (stage != "II")
        assert len(os.listdir(exp / "visualization" / "iter_2")) == 2
        prev = stage


def _state_tensors(path):
    """Every tensor of a training state file, flattened by name."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}.{k}", x)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                walk(f"{prefix}.{i}", x)
        else:
            out[prefix] = v

    walk("", payload)
    return out


@pytest.mark.parametrize("stage", ["I", "III"])
def test_resume_is_exact(runs, stage):
    """4 steps in one run against 2 steps and a resume to 4 (the second
    epoch starts at step 4: 3 batches an epoch), fp32 on the CPU, two
    loader workers: the step-4 training states and exports are equal, bit
    for bit, and so are the logged losses of steps 3 and 4."""
    root, run = runs
    extra = ["--no-lpips"]
    if stage == "III":
        if not (root / "exp" / "teacher" / "net_g_2.pth").exists():
            assert run("I", "teacher", "--total-iter", "2", "--no-lpips") == 0
        extra += ["--teacher-ckpt", str(root / "exp" / "teacher" / "net_g_2.pth")]
    assert run(stage, f"once_{stage}", "--total-iter", "4", *extra) == 0
    assert run(stage, f"twice_{stage}", "--total-iter", "2", *extra) == 0
    assert run(stage, f"twice_{stage}", "--total-iter", "4", *extra) == 0
    once, twice = root / "exp" / f"once_{stage}", root / "exp" / f"twice_{stage}"
    a, b = _state_tensors(once / "state" / "4.pth"), _state_tensors(twice / "state" / "4.pth")
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert a[".step"] == 4 and a[".loader.epoch"] == 1 and a[".loader.consumed"] == 1
    assert a[".sched_g.last_epoch"] == 4
    for name in ("net_g_4.pth", "net_d_4.pth"):
        ea, eb = _state_tensors(once / name), _state_tensors(twice / name)
        assert ea.keys() == eb.keys() and all(torch.equal(ea[k], eb[k]) for k in ea)
    la = {r["step"]: r for r in _jsonl(once / "metrics.jsonl") if "it_per_s" in r}
    lb = {r["step"]: r for r in _jsonl(twice / "metrics.jsonl") if "it_per_s" in r}
    for s in (3, 4):
        assert {k: v for k, v in la[s].items() if k != "it_per_s"} == \
            {k: v for k, v in lb[s].items() if k != "it_per_s"}
    timings = _jsonl(twice / "timings.jsonl")
    assert [(t["start_step"], t["end_step"]) for t in timings] == [(0, 2), (2, 4)]
    assert timings[1]["restore"]["step"] == 2 and timings[1]["restore"]["loader"] == {
        "epoch": 0, "consumed": 2, "batches_per_epoch": 3, "batch_size": 2}


def test_train_cli_refusals(runs, tmp_path):
    """--devices 2 with a global batch (2 ranks x 4) larger than the dataset
    (a rank's refusal fails the run), a stage-III resume without
    --teacher-ckpt, an orbax export directory as a checkpoint, a dataset
    smaller than one batch, and a resume with another batch size (which
    would place the restored step elsewhere in the epochs) are refused."""
    root, run = runs
    with pytest.raises(SystemExit, match="fewer than one batch of 8"):
        run("I", "refused", "--devices", "2", "--batch-size", "4", "--no-lpips")
    os.makedirs(root / "exp" / "resume_III")
    (root / "exp" / "resume_III" / "latest").write_text("2")
    with pytest.raises(SystemExit, match="needs --teacher-ckpt"):
        run("III", "resume_III", "--no-lpips")
    with pytest.raises(ValueError, match="flax_to_state_dict"):
        run("III", "orbax_III", "--no-lpips", "--teacher-ckpt", str(tmp_path))
    with pytest.raises(SystemExit, match="fewer than one batch"):
        run("I", "too_small", "--batch-size", "7")
    assert run("I", "rebatch", "--total-iter", "1", "--no-lpips") == 0
    with pytest.raises(ValueError, match="saved run's dataset and batch size"):
        run("I", "rebatch", "--total-iter", "2", "--no-lpips", "--batch-size", "3")
