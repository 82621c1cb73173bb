"""The port's `VideoRestorer.restore_video` (the file path) against the JAX
package's, on the CPU at the small geometry (`small_configs`, fp32, B=4).

Both restore the same seeded 10-frame 32x32 clip (prime + 2 full chunks +
1 padded chunk) through the native libav shim.  Tolerances: restored
frames within 1 LSB of JAX's (both packages pick the same code for every
token at this seed; float values within 1e-4 round apart at most by one);
the port's frames bit-equal across `inflight` 1 and 3, and to
`restore_chunk` over the frames the same reader decodes; in yuv420 mode
the decoded luma within a mean |d| of 3 of JAX's yuv420 file (JAX's own
bound for its rgb-vs-yuv420 check: decoded RGB mixes chroma back in)."""

import threading

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu_torch.pipeline as pl
from pgtformer_tpu.pipeline import VideoRestorer as JaxVideoRestorer
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.io.native import NativeVideoUnavailable, load_library
from pgtformer_tpu_torch.pipeline import VideoRestorer
from tests.test_torch_common import one_torch_thread, small_configs, small_pgt  # noqa: F401
from tests.test_torch_pipeline import _chunks

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_FRAMES = 10
PHASES = {"decode", "first_chunk", "dispatch", "readback", "encode(threaded)"}


@pytest.fixture(scope="module")
def native_lib():
    try:
        return load_library()
    except NativeVideoUnavailable as e:
        pytest.skip(f"native video io unavailable: {e}")


@pytest.fixture(scope="module")
def clip_file(tmp_path_factory):
    import cv2
    path = str(tmp_path_factory.mktemp("rv") / "in.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    rng = np.random.default_rng(7)
    for _ in range(N_FRAMES):
        w.write(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    w.release()
    return path


def _restorer(v, batch_windows=4, **kw):
    return VideoRestorer(flax_to_state_dict(v), small_configs()[1], w=1.0,
                         batch_windows=batch_windows, dtype=torch.float32, device="cpu", **kw)


def _run(r, src, out, **kw):
    frames = []
    stats = r.restore_video(src, out, frame_callback=lambda i, f: frames.append((i, f.copy())),
                            **kw)
    assert [i for i, _ in frames] == list(range(N_FRAMES))
    return np.stack([f for _, f in frames]), stats


@pytest.fixture(scope="module")
def runs(small_pgt, native_lib, clip_file, tmp_path_factory):
    """{name: (frames from frame_callback, stats)} of JAX's and the port's
    runs (native I/O, mpeg4)."""
    _, v, _, _ = small_pgt
    d = tmp_path_factory.mktemp("rv_out")
    out = {}
    jr = JaxVideoRestorer(v, small_configs()[0], w=1.0, batch_windows=4, dtype=jnp.float32,
                          io_backend="native", inflight=3)
    out["jax"] = _run(jr, clip_file, str(d / "jax.mp4"), codec="mpeg4")
    for inflight in (1, 3):
        out[f"native{inflight}"] = _run(_restorer(v, io_backend="native", inflight=inflight),
                                        clip_file, str(d / f"n{inflight}.mp4"), codec="mpeg4")
    out["opencv"] = _run(_restorer(v, io_backend="opencv"), clip_file, str(d / "cv.mp4"))
    return out


@pytest.mark.parametrize("inflight", [1, 3])
def test_frames_within_1_lsb_of_jax(runs, inflight):
    ours, _ = runs[f"native{inflight}"]
    ref, _ = runs["jax"]
    assert ours.shape == ref.shape == (N_FRAMES, 32, 32, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_frames_independent_of_inflight(runs):
    assert np.array_equal(runs["native1"][0], runs["native3"][0])


@pytest.mark.parametrize("backend", ["native", "opencv"])
def test_frames_equal_restore_chunk_over_own_decode(runs, small_pgt, clip_file, backend):
    """The file path's frames are `restore_chunk`'s over the frames the
    same reader decodes, bit for bit."""
    _, v, _, _ = small_pgt
    reader = pl._open_reader(clip_file, backend)
    decoded = list(reader)
    reader.close()
    assert len(decoded) == N_FRAMES
    r = _restorer(v)
    r.prime(decoded[0])
    ref = np.concatenate([r.restore_chunk(c).numpy()[:n] for c, n in _chunks(decoded)])
    got = runs["native3" if backend == "native" else "opencv"][0]
    assert np.array_equal(got, ref)


def test_stats_and_phases(runs):
    """The JAX package's stats keys, with `startup_seconds` for its
    `compile_seconds`, and `phases` with the port's names (`first_chunk` for
    JAX's `compile`); beside them the port names its `reader` and `writer`."""
    _, jstats = runs["jax"]
    for name in ("native1", "native3", "opencv"):
        _, stats = runs[name]
        assert set(stats) == (set(jstats) - {"compile_seconds"}
                              | {"startup_seconds", "reader", "writer"})
        native = name.startswith("native")
        assert (stats["reader"], stats["writer"]) == (
            ("native", "native:mpeg4") if native else ("opencv", "opencv:mp4v"))
        assert stats["frames"] == jstats["frames"] == N_FRAMES
        assert set(stats["phases"]) == PHASES
        assert set(jstats["phases"]) == PHASES - {"first_chunk"} | {"compile"}
        counts = {k: v["count"] for k, v in stats["phases"].items()}
        assert counts == {"decode": N_FRAMES + 1, "first_chunk": 1, "dispatch": 2,
                          "readback": 3, "encode(threaded)": 1}
        assert all(v["total_s"] >= 0 for v in stats["phases"].values())


def _decode(path):
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def test_yuv420_file_matches_jax(small_pgt, native_lib, clip_file, tmp_path):
    import cv2
    _, v, _, _ = small_pgt
    jr = JaxVideoRestorer(v, small_configs()[0], w=1.0, batch_windows=4, dtype=jnp.float32,
                          io_backend="native", readback="yuv420")
    jstats = jr.restore_video(clip_file, str(tmp_path / "jax.mp4"))
    stats = _restorer(v, io_backend="native", readback="yuv420").restore_video(
        clip_file, str(tmp_path / "ours.mp4"))
    assert stats["frames"] == jstats["frames"] == N_FRAMES
    a, b = _decode(str(tmp_path / "ours.mp4")), _decode(str(tmp_path / "jax.mp4"))
    assert a.shape == b.shape == (N_FRAMES, 32, 32, 3)
    ya = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV)[..., 0] for f in a]).astype(int)
    yb = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2YUV)[..., 0] for f in b]).astype(int)
    assert np.abs(ya - yb).mean() < 3.0


def test_frame_callback_with_yuv420_raises(small_pgt, clip_file, tmp_path, monkeypatch):
    _, v, _, _ = small_pgt
    opened = []
    monkeypatch.setattr(pl, "_open_reader", lambda *a: opened.append(a))
    r = _restorer(v, readback="yuv420")
    with pytest.raises(ValueError, match="readback='rgb'"):
        r.restore_video(clip_file, str(tmp_path / "x.mp4"), frame_callback=lambda i, f: None)
    assert opened == []


@pytest.mark.parametrize("cause", ["no native library", "encoder missing from libav"])
def test_named_codec_under_auto_falls_back_to_mp4v_loudly(small_pgt, clip_file, tmp_path,
                                                          monkeypatch, request, cause):
    """Under io_backend='auto' a named codec that the native writer cannot
    open is written as OpenCV mp4v, as in the JAX package, but not
    silently: a RuntimeWarning names the codec and `stats` the writer.
    Under io_backend='native' the same request raises."""
    import pgtformer_tpu_torch.io.native as native
    _, v, _, _ = small_pgt
    if cause == "no native library":      # a host without libav's headers
        codec = "libx265:preset=ultrafast"

        def unavailable():
            raise NativeVideoUnavailable("pkg-config found no libavcodec")
        monkeypatch.setattr(native, "load_library", unavailable)
    else:
        request.getfixturevalue("native_lib")
        codec = "nosuchcodec"
    with pytest.warns(RuntimeWarning, match=f"codec '{codec}' not written"):
        frames, stats = _run(_restorer(v, io_backend="auto"), clip_file,
                             str(tmp_path / "auto.mp4"), codec=codec)
    assert stats["writer"] == "opencv:mp4v"
    assert stats["reader"] == ("opencv" if cause == "no native library" else "native")
    reader = pl._open_reader(str(tmp_path / "auto.mp4"), "opencv")
    assert len(list(reader)) == N_FRAMES == len(frames)
    reader.close()
    with pytest.raises((IOError, NativeVideoUnavailable)):
        _restorer(v, io_backend="native").restore_video(clip_file, str(tmp_path / "n.mp4"),
                                                        codec=codec)


def test_writer_failure_surfaces_not_hangs(small_pgt, clip_file, tmp_path, monkeypatch):
    """A writer that raises surfaces its error to the caller within the
    bound, and the reader, the readback pool and the writer thread are all
    released afterwards."""
    _, v, _, _ = small_pgt

    class BoomWriter:
        def write(self, frame):
            raise RuntimeError("encoder exploded")

        def close(self):
            pass

    readers, pools = [], []
    real_open_reader = pl._open_reader

    def open_reader(*a):
        rd = real_open_reader(*a)
        close = rd.close
        readers.append([rd, False])

        def closing():
            readers[-1][1] = True
            close()
        rd.close = closing
        return rd

    class Pool(pl.ThreadPoolExecutor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pools.append(self)

    monkeypatch.setattr(pl, "_open_writer", lambda *a, **k: BoomWriter())
    monkeypatch.setattr(pl, "_open_reader", open_reader)
    monkeypatch.setattr(pl, "ThreadPoolExecutor", Pool)
    r = _restorer(v, batch_windows=2, inflight=1)
    err = []

    def target():
        try:
            r.restore_video(clip_file, str(tmp_path / "out.mp4"))
        except BaseException as e:
            err.append(e)
    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(60.0)
    assert not t.is_alive(), "restore_video hung on a dead writer"
    assert len(err) == 1 and isinstance(err[0], RuntimeError)
    assert "encoder exploded" in str(err[0])
    assert [closed for _, closed in readers] == [True]
    assert len(pools) == 1 and pools[0]._shutdown
    assert not any(th.name == "restore_video-writer" and th.is_alive()
                   for th in threading.enumerate())
