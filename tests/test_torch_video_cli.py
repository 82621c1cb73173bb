"""The port's restoration CLI (`pgtformer_tpu_torch.cli.main`) against the
JAX package's, on the CPU.

Both CLIs take `SMALL_PGT` (tests/test_train.py) as their RELEASE_PGTFORMER,
the same seeded reference-format `.pth` through `--weights`, `--fp32
--batch 4 --codec mpeg4` (the port also `--device cpu`) and the same
seeded 10-frame 32x32 clip.  Checks:
- `--dump-frames` PNGs within 1 LSB (fp32 in both; the restored values
  differ by summation order only);
- `--encode-quality-check`: the same labels, and the PSNR, SSIM and
  `vmaf(own-impl)` values within one unit of their printed precision (each
  CLI scores its own encode of its own restored frames);
- `--readback auto`, `--inflight` and the codec string composed from
  `--codec/--encoder-preset/--codec-params` resolve as in JAX (both CLIs'
  VideoRestorer replaced by a recorder);
- `--fp32` on `cuda` is refused."""

import contextlib
import io
import os
import re

import cv2
import numpy as np
import pytest
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu_torch.config as tcfg
from tests.test_torch_common import one_torch_thread  # noqa: F401
from tests.test_torch_eval_cli import _weights, port_config
from tests.test_train import SMALL_PGT

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 10


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("video_cli")
    w = cv2.VideoWriter(str(d / "in.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    rng = np.random.default_rng(5)
    for _ in range(N_FRAMES):
        w.write(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    w.release()
    _weights(str(d / "pgt.pth"))
    return d


@contextlib.contextmanager
def _small_release():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg, "RELEASE_PGTFORMER", SMALL_PGT)
        mp.setattr(tcfg, "RELEASE_PGTFORMER", port_config(SMALL_PGT))
        yield mp


def _main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(files):
    """{"jax"|"port": (stdout, dump dir, output file)}."""
    from pgtformer_tpu.cli import main as jax_main
    from pgtformer_tpu_torch.cli import main as port_main
    d = files
    common = ["-i", str(d / "in.mp4"), "--weights", str(d / "pgt.pth"), "--fp32",
              "--batch", "4", "--codec", "mpeg4", "--encode-quality-check"]
    out = {}
    with _small_release():
        for name, main, extra in (("jax", jax_main, []),
                                  ("port", port_main, ["--device", "cpu"])):
            dump, video = str(d / f"{name}_png"), str(d / f"{name}.mp4")
            out[name] = (_main(main, common + extra + ["-o", video, "--dump-frames", dump]),
                         dump, video)
    return out


def test_dump_frames_within_1_lsb(runs):
    (_, jd, _), (_, td, _) = runs["jax"], runs["port"]
    names = sorted(os.listdir(td))
    assert names == sorted(os.listdir(jd)) == [f"{i:08d}.png" for i in range(N_FRAMES)]
    for n in names:
        a = cv2.imread(os.path.join(td, n)).astype(int)
        b = cv2.imread(os.path.join(jd, n)).astype(int)
        assert a.shape == b.shape == (32, 32, 3)
        assert np.abs(a - b).max() <= 1, n


def test_output_files_decode(runs):
    for name in ("jax", "port"):
        cap = cv2.VideoCapture(runs[name][2])
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == N_FRAMES
        cap.release()


def test_quality_check_lines_agree(runs):
    """The same lines with the same labels; every number within one unit
    of the digit it is printed to."""
    lines = {}
    for name in ("jax", "port"):
        text = runs[name][0]
        lines[name] = [ln for ln in text.splitlines()
                       if ln.startswith(("encode quality", "vmaf(own-impl)"))]
    assert len(lines["port"]) == len(lines["jax"]) == 2
    for a, b in zip(lines["port"], lines["jax"]):
        assert re.sub(r"[\d.]+", "#", a) == re.sub(r"[\d.]+", "#", b)
        for tok_a, tok_b in zip(re.findall(r"\d+\.?\d*", a), re.findall(r"\d+\.?\d*", b)):
            unit = 10.0 ** -len(tok_a.split(".")[1]) if "." in tok_a else 0.0
            assert abs(float(tok_a) - float(tok_b)) <= unit + 1e-9, (a, b)
    assert "psnr" in lines["port"][0] and "ssim" in lines["port"][0]
    assert lines["port"][1].startswith(f"vmaf(own-impl) (first {N_FRAMES} frames):")


def test_rate_and_phase_lines(runs):
    text = runs["port"][0]
    assert re.search(rf"^restored {N_FRAMES} frames in .* fps; steady .* startup .*; "
                     r"reader native, writer native:mpeg4\)$", text, re.M)
    phases = re.search(r"^phase totals: (.*)$", text, re.M).group(1)
    assert [p.rsplit(" ", 1)[0] for p in phases.split(", ")] == \
        ["decode", "first_chunk", "dispatch", "readback", "encode(threaded)"]


class _Recorder:
    """Stands in for either package's VideoRestorer: records what the CLI
    asked for and restores nothing."""
    seen = []

    def __init__(self, *a, **kw):
        self.kw = kw

    def restore_video(self, *a, codec="auto", **kw):
        self.seen.append((self.kw["readback"], self.kw["inflight"], codec))
        return {"frames": 0, "seconds": 0.0, "fps": 0.0, "steady_fps": 0.0,
                "compile_seconds": 0.0, "startup_seconds": 0.0, "phases": {}}


@pytest.mark.parametrize("flags", [
    [], ["--dump-frames", "{tmp}"], ["--encode-quality-check"],
    ["--readback", "rgb", "--inflight", "1"], ["--readback", "yuv420", "--inflight", "5"],
    ["--codec", "libx264", "--encoder-preset", "ultrafast", "--codec-params", "tune=zerolatency"],
    ["--encoder-preset", "superfast", "--codec-params", "pools=1,frame-threads=4"],
    ["--codec", "mpeg4", "--encoder-preset", "fast", "--codec-params", "mbd=2"],
], ids=["default", "dump", "qcheck", "rgb", "yuv420", "x264", "auto-preset", "mpeg4"])
def test_flags_resolve_as_in_jax(files, tmp_path, flags):
    import pgtformer_tpu.pipeline as jpl
    import pgtformer_tpu_torch.pipeline as tpl
    from pgtformer_tpu.cli import main as jax_main
    from pgtformer_tpu_torch.cli import main as port_main
    flags = [f.format(tmp=str(tmp_path / "png")) for f in flags]
    common = ["-i", str(files / "in.mp4"), "-o", str(tmp_path / "o.mp4"),
              "--weights", str(files / "pgt.pth"), "--fp32"] + flags
    seen = []
    with _small_release() as mp:
        mp.setattr(_Recorder, "seen", seen)
        mp.setattr(jpl, "VideoRestorer", _Recorder)
        mp.setattr(tpl, "VideoRestorer", _Recorder)
        _main(jax_main, common)
        _main(port_main, common + ["--device", "cpu"])
    assert len(seen) == 2 and seen[0] == seen[1], seen


def test_pick_readback_rules(monkeypatch):
    """`auto` needs the native writer and an even size; host RGB needs rgb."""
    from pgtformer_tpu_torch.cli import pick_readback
    from pgtformer_tpu_torch.io import native
    assert pick_readback("rgb", False, 32) == "rgb"
    assert pick_readback("auto", False, 33) == "rgb"
    assert pick_readback("auto", True, 32) == "rgb"

    def unavailable():
        raise native.NativeVideoUnavailable("no libav headers")
    monkeypatch.setattr(native, "load_library", unavailable)
    assert pick_readback("auto", False, 32) == "rgb"


def test_fp32_on_cuda_refused(files, capsys):
    """--fp32 is no longer refused on the card (the kernels take fp32 in
    their fp32 form); on a host without one the run fails on the missing
    device instead, before any work."""
    from pgtformer_tpu_torch.cli import main
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-i", str(files / "in.mp4"), "-o", "o.mp4", "--fp32", "--device", "cuda"])
        assert "needs --device cpu" not in capsys.readouterr().err
