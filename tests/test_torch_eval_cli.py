"""The port's evaluation CLI against the JAX package's, on the CPU.

Both CLIs run on the same seeded VFHQ-Test tree (32x32 PNGs: clip_a with 2
frames, clip_b with 1) with `SMALL_PGT` (tests/test_train.py) as their
RELEASE_PGTFORMER, the same reference-format `.pth` of a seeded port model
through their own `--weights`, `--fp32 --batch 2` (the second batch is a
one-sample tail: JAX repeats it to the batch size, the port runs it alone)
and `--face-metrics`:
- case "plain": `--limit 3 --lpips-weights <seeded lpips state dict>`
  (LPIPS and the gray-patch Deg proxy);
- case "rotate": `--rotate --arcface-weights <seeded tiny IResNet>` (both
  packages' ArcFaceEmbedder swapped for IResNet(layers=(1,1,1,1)) so that
  the strict load, the alignment and the forward run at a test's cost);
  without `--lpips-weights`, so LPIPS is each package's own random VGG,
  drawn by different generators: that column is held to its label and a
  finite value only.
Every sample's metrics (captured unrounded from each CLI's `_accumulate`)
and every printed line are compared; the `--save-dir` PNGs within 1 LSB.

Tolerances (fp32 in both; the restored frames differ by summation order):
PSNR 1e-3 dB, SSIM 1e-5, LPIPS 1e-5 relative, Deg 1e-3 degrees (the gray
patch, and ArcFace on crops aligned from parser landmarks), LMD and TLME
0.05 px (a parser cell is 0.5 px at 32x32; a near-tie cell that flips
moves a class centroid by a fraction of that), MSRL equal (every crop is
larger than the image: inf in both).  A printed mean may differ
from JAX's by one unit in its fourth decimal on top of these.
"""

import contextlib
import dataclasses
import functools
import io
import os

import cv2
import numpy as np
import pytest
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu_torch.config as tcfg
from tests.test_torch_common import one_torch_thread, small_lpips  # noqa: F401
from tests.test_torch_train_parts import _lpips_layout
from tests.test_train import SMALL_PGT

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = (1, 1, 1, 1)
TOL = {"psnr": 1e-3, "ssim": 1e-5, "deg(proxy-embedder)": 1e-3, "deg": 1e-3,
       "lmd(parser-lm)": 0.05, "tlme(parser-lm)": 0.05}
LPIPS_RTOL = 1e-5
CASES = {
    "plain": ["--limit", "3", "--lpips-weights", "{lpips}"],
    "rotate": ["--rotate", "--arcface-weights", "{arcface}"],
}


def port_config(c):
    """The JAX package's PGTFormerConfig as the port's."""
    d = dataclasses.asdict(c)
    vq = d.pop("vqvae")
    dd = vq.pop("ddconfig")
    return tcfg.PGTFormerConfig(vqvae=tcfg.VQVAEConfig(ddconfig=tcfg.DDConfig(**dd), **vq), **d)


def _tree(root):
    rng = np.random.default_rng(0)
    for clip, n in (("clip_a", 2), ("clip_b", 1)):
        os.makedirs(os.path.join(root, "GT", clip))
        for i in range(n):
            cv2.imwrite(os.path.join(root, "GT", clip, f"{i:08d}.png"),
                        rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))


def _weights(path):
    """A seeded port PGTFormer at SMALL_PGT, every tensor moved off its init
    (the SFT heads start at zero, the BN statistics at 0/1)."""
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    g = torch.Generator().manual_seed(3)
    sd = PGTFormer(port_config(SMALL_PGT), generator=g).state_dict()
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(a.shape, generator=g) + 0.5
        elif a.is_floating_point():
            sd[k] = a + torch.randn(a.shape, generator=g) * 0.02
    torch.save({"params_ema": sd}, path)


def _arcface_weights(path):
    from pgtformer_tpu_torch.eval.arcface import IResNet
    from pgtformer_tpu_torch.nn.blocks import init_weights
    g = torch.Generator().manual_seed(5)
    sd = init_weights(IResNet(TINY), g).state_dict()
    for k, a in sd.items():
        if k.endswith("running_var"):
            sd[k] = torch.rand(a.shape, generator=g) + 0.5
        elif k.endswith(("running_mean", "bias")):
            sd[k] = torch.randn(a.shape, generator=g) * 0.1
    torch.save(sd, path)


def _run(main, argv, mod):
    """main(argv) with its stdout and every sample's unrounded row."""
    rows = []
    acc = mod._accumulate

    def capture(rows_, *a, **k):
        acc(rows_, *a, **k)
        rows.append(rows_[-1])

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "_accumulate", capture)
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    return rc, out.getvalue(), rows


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_cli")
    _tree(str(d / "vfhq"))
    _weights(str(d / "pgt.pth"))
    _arcface_weights(str(d / "backbone.pth"))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in _lpips_layout(small_lpips(seed=11)[2]).items()},
               str(d / "lpips_vgg.pth"))
    return d


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, files):
    """(case, JAX (rc, stdout, rows), port (rc, stdout, rows), save dirs)."""
    import pgtformer_tpu.eval.arcface as JA
    import pgtformer_tpu.eval_cli as JC
    import pgtformer_tpu_torch.eval.arcface as TA
    import pgtformer_tpu_torch.eval_cli as TC
    case = request.param
    d = files
    extra = [a.format(lpips=str(d / "lpips_vgg.pth"), arcface=str(d / "backbone.pth"))
             for a in CASES[case]]
    argv = ["--data-root", str(d / "vfhq"), "--weights", str(d / "pgt.pth"), "--fp32",
            "--batch", "2", "--face-metrics", *extra]
    saves = {pkg: str(d / f"{case}_{pkg}") for pkg in ("jax", "port")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg, "RELEASE_PGTFORMER", SMALL_PGT)
        mp.setattr(tcfg, "RELEASE_PGTFORMER", port_config(SMALL_PGT))
        mp.setattr(JA, "ArcFaceEmbedder", functools.partial(JA.ArcFaceEmbedder, layers=TINY))
        mp.setattr(TA, "ArcFaceEmbedder", functools.partial(TA.ArcFaceEmbedder, layers=TINY))
        jax_run = _run(JC.main, argv + ["--save-dir", saves["jax"]], JC)
        port_run = _run(TC.main, argv + ["--save-dir", saves["port"], "--device", "cpu"], TC)
    return case, jax_run, port_run, saves


def _lines(stdout):
    out = {}
    for line in stdout.strip().splitlines():
        k, v = line.rsplit(":", 1)
        out[k] = float(v)
    return out


def test_eval_cli_prints_jax_lines(runs):
    case, (jrc, jout, _), (trc, tout, _), _ = runs
    assert jrc == trc == 0
    ref, ours = _lines(jout), _lines(tout)
    assert list(ours) == list(ref)
    assert ref["samples"] == ours["samples"] == 3
    lp = "lpips" if case == "plain" else "lpips(random-vgg)"
    deg = "deg(proxy-embedder)" if case == "plain" else "deg"
    assert list(ref) == ["samples", "psnr", "ssim", lp, deg, "lmd(parser-lm)",
                         "msrl(own-def)", "tlme(parser-lm)"]
    for k, v in ref.items():
        if k == "lpips":
            np.testing.assert_allclose(ours[k], v, rtol=LPIPS_RTOL, atol=1e-4)
        elif k == "lpips(random-vgg)":
            assert np.isfinite(ours[k]) and ours[k] > 0
        elif k != "samples":
            assert ours[k] == v or abs(ours[k] - v) <= TOL.get(k, 0.0) + 1e-4, (k, ours[k], v)


def test_eval_cli_samples_match_jax(runs):
    """Every sample's unrounded metrics, the tail sample included."""
    case, (_, _, jrows), (_, _, trows), _ = runs
    assert len(jrows) == len(trows) == 3
    for i, (ref, ours) in enumerate(zip(jrows, trows)):
        assert list(ours) == list(ref)
        for k, v in ref.items():
            if k == "lpips":
                np.testing.assert_allclose(ours[k], v, rtol=LPIPS_RTOL, err_msg=f"{i} {k}")
            elif k == "lpips(random-vgg)":
                assert np.isfinite(ours[k])
            elif k == "msrl(own-def)":
                assert ours[k] == v == float("inf")
            else:
                assert abs(ours[k] - v) <= TOL[k], (i, k, ours[k], v)


def test_eval_cli_saved_frames_match_jax(runs):
    _, _, _, saves = runs
    names = sorted(os.listdir(saves["jax"]))
    assert names == sorted(os.listdir(saves["port"])) == [
        "clip_a_00000000.png", "clip_a_00000001.png", "clip_b_00000000.png"]
    for name in names:
        a = cv2.imread(os.path.join(saves["jax"], name)).astype(int)
        b = cv2.imread(os.path.join(saves["port"], name)).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, name


def test_eval_cli_refusals(files):
    from pgtformer_tpu_torch import eval_cli
    base = ["--data-root", str(files / "vfhq"), "--weights", str(files / "pgt.pth")]
    with pytest.raises(SystemExit) as e:
        eval_cli.main(base + ["--fp32", "--device", "cuda"])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_cli.main(base)


def test_eval_cli_no_samples(tmp_path, capsys, monkeypatch):
    from pgtformer_tpu_torch import eval_cli
    os.makedirs(tmp_path / "GT")
    monkeypatch.setattr(tcfg, "RELEASE_PGTFORMER", port_config(SMALL_PGT))
    assert eval_cli.main(["--data-root", str(tmp_path), "--fp32", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "no samples evaluated" in err and "random weights" in err
