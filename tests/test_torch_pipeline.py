"""The serving slice end to end: the port's VideoRestorer against the JAX
package's on the same seeded clip (CPU, fp32, small geometry).

At this seed the two packages pick the same code for every token (see
test_torch_models.test_pgtformer_full_parity), so the restored uint8
frames agree to within 1 LSB (rounding of values within 1e-4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pgtformer_tpu.pipeline import VideoRestorer as JaxVideoRestorer
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.pipeline import VideoRestorer, _rgb_to_yuv420
from tests.test_torch_common import small_configs, small_pgt  # noqa: F401

N_FRAMES = 10   # prime + 2 full chunks of 4 + 1 frame that needs end padding


@pytest.fixture(scope="module")
def restorers(small_pgt):
    _, v, _, _ = small_pgt
    jc, tc = small_configs()
    jr = JaxVideoRestorer(v, jc, w=1.0, batch_windows=4, dtype=jnp.float32,
                          io_backend="opencv")
    tr = VideoRestorer(flax_to_state_dict(v), tc, w=1.0, batch_windows=4,
                       dtype=torch.float32, device="cpu", io_backend="opencv")
    return jr, tr


@pytest.fixture(scope="module")
def clip():
    return np.random.default_rng(7).integers(0, 256, (N_FRAMES, 32, 32, 3), dtype=np.uint8)


def _chunks(frames, B=4, r=1):
    """The chunk schedule of restore_video: frame 0 primes; chunks of B;
    the tail padded with the last frame until q + r outputs are owed."""
    rest = list(frames[1:])
    out = []
    while len(rest) >= B:
        out.append((np.stack(rest[:B]), B))
        rest = rest[B:]
    needed = len(rest) + r
    while needed > 0:
        chunk = rest + [frames[-1]] * (B - len(rest))
        out.append((np.stack(chunk), min(B, needed)))
        needed -= min(B, needed)
        rest = []
    return out


def test_restore_chunk_matches_jax(restorers, clip):
    jr, tr = restorers
    jr.prime(clip[0])
    tr.prime(clip[0])
    ours, ref = [], []
    for chunk, n_valid in _chunks(clip):
        ref.append(np.asarray(jr.restore_chunk(chunk))[:n_valid])
        out = tr.restore_chunk(chunk)
        assert out.dtype == torch.uint8 and out.shape == (4, 32, 32, 3)
        ours.append(out.numpy()[:n_valid])
    ours, ref = np.concatenate(ours), np.concatenate(ref)
    assert ours.shape == ref.shape == (N_FRAMES, 32, 32, 3)
    diff = np.abs(ours.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()


def test_restore_video_matches_jax(restorers, clip, tmp_path):
    import cv2
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    for f in clip:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()
    jr, tr = restorers
    seen = []
    stats = tr.restore_video(src, str(tmp_path / "ours.mp4"),
                             frame_callback=lambda i, f: seen.append(i))
    jstats = jr.restore_video(src, str(tmp_path / "ref.mp4"))
    assert stats["frames"] == jstats["frames"] == N_FRAMES
    assert seen == list(range(N_FRAMES))

    def read_all(p):
        cap = cv2.VideoCapture(p)
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        return np.stack(frames).astype(int)

    a, b = read_all(str(tmp_path / "ours.mp4")), read_all(str(tmp_path / "ref.mp4"))
    assert a.shape == b.shape == (N_FRAMES, 32, 32, 3)
    # same restored frames (within 1 LSB) through the same mp4v encoder
    assert np.abs(a - b).mean() < 1.0


def test_restore_chunk_yuv420_readback(small_pgt, clip):
    """readback='yuv420' returns the device-side BT.601 planes of the same
    restoration (within the RGB path's uint8 rounding)."""
    _, v, _, _ = small_pgt
    kw = dict(cfg=small_configs()[1], batch_windows=4, dtype=torch.float32, device="cpu")
    rgb_r = VideoRestorer(flax_to_state_dict(v), **kw)
    yuv_r = VideoRestorer(flax_to_state_dict(v), readback="yuv420", **kw)
    for r in (rgb_r, yuv_r):
        r.prime(clip[0])
    rgb = rgb_r.restore_chunk(clip[1:5])
    planes = yuv_r.restore_chunk(clip[1:5])
    for ours, ref, shape in zip(planes, _rgb_to_yuv420(rgb.float() / 255.0),
                                [(4, 32, 32), (4, 16, 16), (4, 16, 16)]):
        assert ours.dtype == torch.uint8 and ours.shape == shape
        assert (ours.int() - ref.int()).abs().max() <= 1


def test_restore_chunk_needs_prime(small_pgt):
    _, v, _, _ = small_pgt
    r = VideoRestorer(flax_to_state_dict(v), small_configs()[1], batch_windows=2,
                      dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="prime"):
        r.restore_chunk(np.zeros((2, 32, 32, 3), np.uint8))


def test_entry_points_refuse_cpu_fallback():
    """With no card and no explicit device, VideoRestorer and the CLI raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from pgtformer_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoRestorer()
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-i", "in.mp4", "-o", "out.mp4"])
