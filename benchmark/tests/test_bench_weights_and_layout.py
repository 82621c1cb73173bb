"""The seeded weights, and the harness finding a cell's files by name."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import SMALL_CF, small_spec
from reference import layers as L
from reference.codeformer import CodeFormer as RefCodeFormer
from reference.pgtformer import PGTFormer as RefPGTFormer
from weights import make_state_dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _shapes(cls, cfg):
    with torch.device("meta"):
        return L.key_shapes(cls(cfg))


@pytest.mark.parametrize("which", ["pgt-video-b8", "codeformer-faces-b16"])
def test_every_key_is_filled_and_loads_strictly(which):
    """Every entry of the state dict is drawn, the port's model takes the
    dict with load_state_dict(strict=True), no bias is zero, and no
    Fuse-SFT head starts as the identity."""
    from pgtformer_tpu_torch.convert import load_into
    spec = small_spec(which)
    if which == "pgt-video-b8":
        from pgtformer_tpu_torch.config import PGTFormerConfig
        from pgtformer_tpu_torch.models.pgtformer import PGTFormer
        cfg = spec.config["model"]
        shapes = _shapes(RefPGTFormer, cfg)
        port = PGTFormer(PGTFormerConfig.from_dict(cfg))
    else:
        from pgtformer_tpu_torch.models.codeformer import CodeFormer
        cfg = dict(SMALL_CF)
        shapes = _shapes(RefCodeFormer, cfg)
        tables = {k: v for k, v in cfg.items() if k.isupper()}
        port = type("CodeFormer", (CodeFormer,), tables)(
            **{k: v for k, v in cfg.items() if not k.isupper()})
    sd = make_state_dict(shapes, 2 ** 33 + 5, spec.config["weights"], torch.bfloat16, "cpu")
    assert list(sd) == [k for k, _ in shapes]
    assert all(v.dtype == torch.bfloat16 and tuple(v.shape) == s
               for (k, s), v in zip(shapes, sd.values()))
    load_into(port, sd)
    for k, v in sd.items():
        if k.endswith("bias"):
            assert v.abs().min() > 0 or v.numel() > 64 and (v == 0).float().mean() < 0.01, k
        if ".scale.2." in k or ".shift.2." in k:
            assert v.float().abs().mean() > 0, k
        if "codebooks" in k and k.endswith("weight"):
            assert torch.all(v[-1] == 0) and v[:-1].float().abs().mean() > 0.5
    # fan-in scaling: a 3x3 conv's weights have std ~ 1/sqrt(9 cin)
    k = next(k for k, s in shapes if len(s) == 4 and s[2] == 3 and ".scale." not in k
             and ".shift." not in k and "conv_out" not in k and "blocks.24" not in k)
    w = sd[k].float()
    assert w.std().item() == pytest.approx(w[0].numel() ** -0.5, rel=0.2)


def test_same_seed_same_weights_and_frames():
    import traffic
    shapes = _shapes(RefPGTFormer, small_spec("pgt-video-b8").config["model"])
    a = make_state_dict(shapes, 3_000_000_007, {}, torch.bfloat16, "cpu")
    b = make_state_dict(shapes, 3_000_000_007, {}, torch.bfloat16, "cpu")
    c = make_state_dict(shapes, 3_000_000_008, {}, torch.bfloat16, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    f1 = traffic.make_frames(2 ** 32 + 1, 5, 32, "cpu")
    assert (f1 == traffic.make_frames(2 ** 32 + 1, 5, 32, "cpu")).all()
    assert f1.dtype.name == "uint8" and f1.shape == (5, 32, 32, 3)


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    """Into a copy of the benchmark, add a configuration, a traffic mix, a
    cell and a per-layer metric as files of their own plus their entries
    in BENCHMARK.json: the harness finds each by its name, and no other
    file is edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "pgtformer-release.json").read_text())
    cfg["name"] = "pgtformer-new"
    (tmp_path / "benchmark" / "configs" / "pgtformer-new.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / "clips240-b8.json").read_text())
    tr["batch"] = 32
    (tmp_path / "benchmark" / "traffic" / "clips240-b32.json").write_text(json.dumps(tr))
    (tmp_path / "benchmark" / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return float(run.traced_calls)\n")
    bench["configs"].append({"name": "pgtformer-new", "source": "https://example.org",
                             "file": "benchmark/configs/pgtformer-new.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "pgt-new-b32", "config": "pgtformer-new",
                               "traffic": "clips240-b32", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "the device",
                               "moves": "frames_per_s", "workloads": ["pgt-new-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    import harness
    spec = harness.load_spec("pgt-new-b32", root=tmp_path)
    assert spec.config["name"] == "pgtformer-new" and spec.traffic["batch"] == 32
    assert "calls_traced" in [m["name"] for m in spec.per_layer]
    assert "k1_roofline" not in [m["name"] for m in spec.per_layer]   # listed for its cells
    reader = harness.load_module(tmp_path / "benchmark" / "metrics" / "calls_traced.py", "m")
    assert reader.read(type("R", (), {"traced_calls": 3})) == 3.0
    old = harness.load_spec("pgt-video-b8", root=tmp_path)
    assert "calls_traced" not in [m["name"] for m in old.per_layer]


def test_the_engine_names_no_cell_config_or_metric():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = ([c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
             + [w["traffic"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    for f in ("run.py", "harness.py", "traffic.py", "judge.py", "weights.py", "devtrace.py"):
        text = (BENCH / f).read_text()
        assert not [n for n in names if n in text], f


def test_refuses_without_the_program_or_a_card(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ prints no
    result and exits with a code other than 0 (here there is no card
    either)."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "pgt-video-b8",
                        "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
