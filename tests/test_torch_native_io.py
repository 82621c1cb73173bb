"""The port's native video I/O (pgtformer_tpu_torch/io/native.py and its
libav shim) and io/video.py, against the JAX package's.

The port builds its own library from its own copy of videoio.cc into
build/native/ at the root of the checkout.  Same libav and the same C++ as
the JAX package's shim, so its reader decodes bit for bit as the JAX
reader does; against OpenCV's decoder the mean |difference| stays under 2
(the JAX test's bound: two RGB conversions of the same YUV).  Tests that
need the native library skip with the reason when it cannot be built."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pgtformer_tpu_torch.io import native
from pgtformer_tpu_torch.io.native import (
    NativeVideoReader, NativeVideoUnavailable, NativeVideoWriter, load_library)
from pgtformer_tpu_torch.io.video import VideoReader, sliding_windows

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 12


@pytest.fixture(scope="module")
def native_lib():
    try:
        return load_library()
    except NativeVideoUnavailable as e:
        pytest.skip(f"native video io unavailable: {e}")


def _gradient_frames(n, hw=64):
    """Smooth moving gradients, so lossy codecs round-trip closely."""
    gx = np.linspace(40, 215, hw, dtype=np.float32)
    base = np.stack([np.tile(gx, (hw, 1)), np.tile(gx[::-1], (hw, 1)),
                     np.tile(gx[:, None], (1, hw))], -1).astype(np.uint8)
    return [np.roll(base, 2 * i, axis=1) for i in range(n)]


@pytest.fixture(scope="module")
def sample_videos(tmp_path_factory, native_lib):
    """{"mp4v": OpenCV-written file, "libx265": the port's writer}, each
    with the frames written."""
    import cv2
    d = tmp_path_factory.mktemp("nv")
    frames = _gradient_frames(N_FRAMES)
    paths = {"mp4v": str(d / "in_mp4v.mp4"), "libx265": str(d / "in_x265.mp4")}
    w = cv2.VideoWriter(paths["mp4v"], cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 64))
    for f in frames:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()
    try:
        w = NativeVideoWriter(paths["libx265"], 25.0, (64, 64), codec="libx265")
    except IOError:
        del paths["libx265"]
    else:
        for f in frames:
            w.write(f)
        w.close()
    return paths, frames


def _read(reader):
    try:
        return list(reader)
    finally:
        reader.close()


def test_library_builds_from_the_ports_source(native_lib):
    """The port loads build/native/libvideoio.so, built from its own
    videoio.cc, newer than that source; the C++ below the header comment is
    the JAX package's, and the C interface is complete."""
    assert native.LIBRARY == REPO / "build" / "native" / "libvideoio.so"
    assert native.SOURCE == REPO / "pgtformer_tpu_torch" / "io" / "native" / "videoio.cc"
    assert native.LIBRARY.stat().st_mtime >= native.SOURCE.stat().st_mtime
    ours = native.SOURCE.read_text()
    ref = (REPO / "pgtformer_tpu" / "io" / "native" / "videoio.cc").read_text()
    assert ours[ours.index("#include"):] == ref[ref.index("#include"):]
    for sym in ("vr_open", "vr_info", "vr_read", "vr_close", "vw_open", "vw_open2",
                "vw_write", "vw_write_yuv420", "vw_close"):
        assert hasattr(native_lib, sym), sym


@pytest.mark.parametrize("kind", ["mp4v", "libx265"])
def test_reader_bit_equal_to_jax(native_lib, sample_videos, kind):
    from pgtformer_tpu.io.native import NativeVideoReader as JaxReader
    paths, _ = sample_videos
    if kind not in paths:
        pytest.skip("libx265 unavailable in this libav build")
    ours, ref = NativeVideoReader(paths[kind]), JaxReader(paths[kind])
    meta = (ours.width, ours.height, ours.fps, ours.frame_count)
    assert meta == (ref.width, ref.height, ref.fps, ref.frame_count)
    assert meta[:2] == (64, 64) and abs(meta[2] - 25.0) < 0.01 and meta[3] == N_FRAMES
    a, b = _read(ours), _read(ref)
    assert len(a) == len(b) == N_FRAMES
    for x, y in zip(a, b):
        assert x.dtype == np.uint8 and np.array_equal(x, y)


def test_reader_matches_opencv(native_lib, sample_videos):
    """Within a mean |d| of 2 of OpenCV's decode of the same file; the
    OpenCV reader's size and frame count as in JAX's io/video.py."""
    from pgtformer_tpu.io.video import VideoReader as JaxCvReader
    path = sample_videos[0]["mp4v"]
    cv, jcv = VideoReader(path), JaxCvReader(path)
    assert (cv.width, cv.height, cv.fps, cv.frame_count) == \
        (jcv.width, jcv.height, jcv.fps, jcv.frame_count) == (64, 64, 25.0, N_FRAMES)
    jcv.close()
    a, b = _read(NativeVideoReader(path)), _read(cv)
    assert len(a) == len(b) == N_FRAMES
    for x, y in zip(a, b):
        assert np.mean(np.abs(x.astype(int) - y.astype(int))) < 2.0


@pytest.mark.parametrize("codec,tol", [("auto", 6.0), ("mpeg4", 6.0), ("libx264", 6.0)])
def test_writer_roundtrip(native_lib, sample_videos, tmp_path, codec, tol):
    _, frames = sample_videos
    out = str(tmp_path / "out.mp4")
    try:
        w = NativeVideoWriter(out, 25, (64, 64), codec=codec)
    except IOError:
        pytest.skip(f"{codec} unavailable in this libav build")
    for f in frames:
        w.write(f)
    w.close()
    decoded = _read(NativeVideoReader(out))
    assert len(decoded) == len(frames)
    err = np.mean([np.abs(a.astype(int) - b.astype(int)).mean()
                   for a, b in zip(decoded, frames)])
    assert err < tol, err


def test_writer_x265_hvc1(native_lib, sample_videos, tmp_path):
    """libx265 CRF 18 output carries the Apple `hvc1` sample entry, never
    `hev1`; `auto` picks libx265 where the libav build has it."""
    _, frames = sample_videos
    for codec in ("libx265", "auto"):
        path = str(tmp_path / f"{codec}.mp4")
        try:
            w = NativeVideoWriter(path, 25.0, (64, 64), codec=codec)
        except IOError:
            pytest.skip("libx265 unavailable in this libav build")
        for f in frames[:4]:
            w.write(f)
        w.close()
        data = open(path, "rb").read()
        assert b"hvc1" in data and b"hev1" not in data, codec
        assert len(_read(NativeVideoReader(path))) == 4


def test_writer_explicit_codec_never_substituted(native_lib, tmp_path):
    """An explicitly requested encoder that the libav build lacks fails;
    `auto` always finds one."""
    with pytest.raises(IOError):
        NativeVideoWriter(str(tmp_path / "x.mp4"), 25.0, (64, 64), codec="libnotacodec")
    assert not (tmp_path / "x.mp4").exists() or os.path.getsize(tmp_path / "x.mp4") == 0
    w = NativeVideoWriter(str(tmp_path / "a.mp4"), 25.0, (64, 64), codec="auto")
    for _ in range(3):
        w.write(np.zeros((64, 64, 3), np.uint8))
    w.close()
    assert len(_read(NativeVideoReader(str(tmp_path / "a.mp4")))) == 3


@pytest.mark.parametrize("codec", ["libx265:preset=ultrafast:params=pools=1,frame-threads=1",
                                   "libx264:preset=ultrafast", "libx264:params=tune=zerolatency",
                                   "mpeg4:params=mbd=2"])
def test_writer_preset_and_params_suffixes(native_lib, tmp_path, codec):
    path = str(tmp_path / "out.mp4")
    try:
        w = NativeVideoWriter(path, 25.0, (64, 64), codec=codec)
    except IOError:
        pytest.skip(f"{codec.split(':')[0]} unavailable in this libav build")
    for _ in range(3):
        w.write(np.zeros((64, 64, 3), np.uint8))
    w.close()
    assert len(_read(NativeVideoReader(path))) == 3


def test_write_yuv420(native_lib, sample_videos, tmp_path):
    """BT.601 planes written directly decode to the frames they came from
    (mpeg4, so the same file in both packages' writers is comparable), and
    the port's writer writes the bytes the JAX writer writes."""
    import cv2
    from pgtformer_tpu.io.native import NativeVideoWriter as JaxWriter
    _, frames = sample_videos
    paths = []
    for cls, name in ((NativeVideoWriter, "ours"), (JaxWriter, "jax")):
        path = str(tmp_path / f"{name}.mp4")
        w = cls(path, 25.0, (64, 64), codec="mpeg4")
        assert w.supports_yuv420
        for f in frames:
            i420 = cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420)
            w.write_yuv420(i420[:64], i420[64:80].reshape(32, 32), i420[80:].reshape(32, 32))
        w.close()
        paths.append(path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    decoded = _read(NativeVideoReader(paths[0]))
    assert len(decoded) == N_FRAMES
    err = np.mean([np.abs(a.astype(int) - b.astype(int)).mean()
                   for a, b in zip(decoded, frames)])
    assert err < 6.0, err


def test_concurrent_builds_both_load(native_lib, tmp_path):
    """Two processes that build at once (as two test workers may) each
    compile to a name of their own and load a whole library."""
    code = ("import sys, pathlib\n"
            "from pgtformer_tpu_torch.io import native\n"
            f"native.LIBRARY = pathlib.Path({str(tmp_path)!r}) / 'libvideoio.so'\n"
            "lib = native.load_library()\n"
            "assert lib.vw_open2 and lib.vr_read\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert sorted(os.listdir(tmp_path)) == ["libvideoio.so"]


@pytest.mark.parametrize("tool", ["g++", "pkg-config"])
def test_unbuildable_raises_unavailable(tmp_path, monkeypatch, tool):
    """A failing compiler or missing libav headers raise
    NativeVideoUnavailable carrying the tool's message, and leave no file."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / tool
    fake.write_text("#!/bin/sh\necho 'fatal error: libavcodec/avcodec.h: no such file' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "libvideoio.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(NativeVideoUnavailable, match="avcodec.h"):
        load_library()
    d = native.LIBRARY.parent        # no library and no temporary left behind
    assert not d.exists() or os.listdir(d) == []


@pytest.mark.parametrize("n,radius", [(0, 1), (1, 1), (2, 1), (5, 1), (5, 2), (3, 0)])
def test_sliding_windows_matches_jax(n, radius):
    from pgtformer_tpu.io.video import sliding_windows as jax_sliding_windows
    frames = [np.full((2, 2, 3), i, np.uint8) for i in range(n)]
    ours = [[int(f[0, 0, 0]) for f in w] for w in sliding_windows(iter(frames), radius)]
    ref = [[int(f[0, 0, 0]) for f in w] for w in jax_sliding_windows(iter(frames), radius)]
    assert ours == ref
    assert len(ours) == n
