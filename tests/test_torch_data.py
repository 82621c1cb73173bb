"""The port's data pipeline against the JAX package's, bit for bit: blur
kernels, noise, JPEG, MATLAB resize and the blind pipeline
(`data/degradations.py`), the VFHQ datasets' samples, the prefetching
loader's batches over two epochs (and its resume inside an epoch),
`device_prefetch`, PSNR/SSIM and the image helpers.

Tolerance: none — every array must equal the JAX package's exactly (same
numpy generator streams, same cv2 calls); PSNR/SSIM (float64 on the host)
to 1e-12 relative.
"""

import json
import os

import cv2
import numpy as np
import pytest

import pgtformer_tpu.data.degradations as jdeg
import pgtformer_tpu_torch.data.degradations as tdeg
from pgtformer_tpu.data import loader as jloader
from pgtformer_tpu.data import vfhq as jvfhq
from pgtformer_tpu_torch.data import loader as tloader
from pgtformer_tpu_torch.data import vfhq as tvfhq


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], str):
        assert list(a) == list(b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- degradations --------------------------------------------------------------

KERNEL_CALLS = [
    ("bivariate_gaussian", (21, 1.3), {}),
    ("bivariate_gaussian", (15, 1.3, 2.1, 0.7), {"isotropic": False}),
    ("bivariate_generalized_gaussian", (21, 2.0), {"beta": 1.7}),
    ("bivariate_generalized_gaussian", (21, 0.8, 2.4, -1.1), {"beta": 0.6, "isotropic": False}),
    ("bivariate_plateau", (21, 1.5), {"beta": 1.2}),
    ("bivariate_plateau", (13, 2.5, 0.4, 2.0), {"beta": 1.9, "isotropic": False}),
    ("circular_lowpass_kernel", (1.7, 21), {}),
    ("circular_lowpass_kernel", (2.5, 11), {"pad_to": 21}),
    ("sigma_matrix", (1.2, 0.3, 0.9), {}),
    ("mesh_grid", (7,), {}),
]


@pytest.mark.parametrize("name,args,kw", KERNEL_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(KERNEL_CALLS)])
def test_kernels_match(name, args, kw):
    _eq(getattr(tdeg, name)(*args, **kw), getattr(jdeg, name)(*args, **kw))


def test_random_mixed_kernel_and_sampler_match():
    for seed in range(12):
        _eq(tdeg.random_mixed_kernel(np.random.default_rng(seed)),
            jdeg.random_mixed_kernel(np.random.default_rng(seed)))
        _eq(tdeg._sample_blur_kernel(np.random.default_rng(seed), 21, 0.5),
            jdeg._sample_blur_kernel(np.random.default_rng(seed), 21, 0.5))


NOISE_CALLS = [
    ("add_gaussian_noise", {"sigma": 7.0}),
    ("add_gaussian_noise", {"sigma": 4.0, "gray": True, "rounds": True}),
    ("add_gaussian_noise", {"sigma": 4.0, "clip": False, "rounds": True}),
    ("random_add_gaussian_noise", {"gray_prob": 0.5}),
    ("add_poisson_noise", {"scale": 1.5}),
    ("add_poisson_noise", {"scale": 0.7, "gray": True, "clip": False}),
    ("random_add_poisson_noise", {"gray_prob": 0.5, "rounds": True}),
    ("random_add_jpeg_compression", {}),
]


@pytest.mark.parametrize("name,kw", NOISE_CALLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(NOISE_CALLS)])
def test_noise_and_jpeg_match(name, kw):
    img = np.random.default_rng(3).uniform(0, 1, (24, 20, 3)).astype(np.float32)
    for seed in range(3):
        _eq(getattr(tdeg, name)(img, np.random.default_rng(seed), **kw),
            getattr(jdeg, name)(img, np.random.default_rng(seed), **kw))
    _eq(tdeg.add_jpeg_compression(img, 37), jdeg.add_jpeg_compression(img, 37))


@pytest.mark.parametrize("scale", [0.25, 0.5, 1.7])
def test_imresize_matlab_matches(scale):
    img = np.random.default_rng(4).uniform(0, 1, (33, 27, 3)).astype(np.float32)
    _eq(tdeg.imresize_matlab(img, scale), jdeg.imresize_matlab(img, scale))


@pytest.mark.parametrize("kw", [
    {},
    {"poisson_prob": 1.0, "gray_noise_prob": 1.0, "sinc_prob": 1.0},
    {"second_order_prob": 1.0, "final_sinc_prob": 1.0, "shared": False},
], ids=["default", "poisson-gray-sinc", "second-order-unshared"])
def test_blind_degrade_clip_matches(kw):
    frames = np.random.default_rng(5).uniform(0, 1, (3, 48, 40, 3)).astype(np.float32)
    for seed in range(3):
        _eq(tdeg.blind_degrade_clip(frames, np.random.default_rng(seed), **kw),
            jdeg.blind_degrade_clip(frames, np.random.default_rng(seed), **kw))


# -- datasets ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vfhq_tree(tmp_path_factory):
    """A seeded VFHQ-layout tree: GT/<clip>/ of 32x32 PNGs (clip_0: 4 frames,
    clip_1: 3), pre-degraded 8x8 LR_Blind frames for clip_0 only, and a
    landmarks.json with five points per GT frame."""
    root = tmp_path_factory.mktemp("vfhq")
    rng = np.random.default_rng(0)
    tmpl = np.array([[192.98, 239.95], [318.90, 240.19], [256.63, 314.02],
                     [201.26, 371.41], [313.09, 371.15]]) / 16.0
    landmarks = {}
    for clip, n in (("clip_0", 4), ("clip_1", 3)):
        os.makedirs(root / "GT" / clip)
        for i in range(n):
            name = f"{i:08d}.png"
            cv2.imwrite(str(root / "GT" / clip / name),
                        rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
            landmarks[f"GT/{clip}/{name}"] = (tmpl + rng.normal(0, 0.5, tmpl.shape)).tolist()
            if clip == "clip_0":
                os.makedirs(root / "LR_Blind" / clip, exist_ok=True)
                cv2.imwrite(str(root / "LR_Blind" / clip / name),
                            rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    (root / "landmarks.json").write_text(json.dumps(landmarks))
    return str(root)


DATASET_CASES = [
    ("VFHQTrainDataset", dict(is_aligned=False, output_dtype="float32")),
    ("VFHQTrainDataset", dict(is_aligned=False, output_dtype="uint8")),
    ("VFHQTrainDataset", dict(is_aligned=True, output_dtype="float32")),
    ("VFHQTrainDataset", dict(is_aligned=True, output_dtype="uint8")),
    ("VFHQTrainDataset", dict(degradation="lr", output_dtype="uint8", seed=9)),
    ("VFHQTestDataset", dict(inter_space=2)),
    ("VFHQRotateTestDataset", dict(output_dtype="uint8", seed=3)),
    ("VFHQClipDataset", dict(r=2, use_hflip=True, upsample_lq=False)),
]


@pytest.mark.parametrize("cls,kw", DATASET_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(DATASET_CASES)])
def test_dataset_samples_match(vfhq_tree, cls, kw):
    """Every index, bit for bit (aligned samples are warped to 512x512)."""
    ours, ref = getattr(tvfhq, cls)(vfhq_tree, **kw), getattr(jvfhq, cls)(vfhq_tree, **kw)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        _eq(ours[i], ref[i])


def test_dataset_explicit_seed_and_registry(vfhq_tree):
    """get(index, seed) equals the JAX dataset with that seed written into
    it, and leaves the port's dataset's seed alone; the datasets register
    under the reference's type names."""
    from pgtformer_tpu_torch.registry import DATASET_REGISTRY
    ours = tvfhq.VFHQTrainDataset(vfhq_tree, output_dtype="uint8")
    ref = jvfhq.VFHQTrainDataset(vfhq_tree, output_dtype="uint8")
    ref.seed = 100003
    for i in range(len(ref)):
        _eq(ours.get(i, 100003), ref[i])
    assert ours.seed == 0
    for name, cls in (("VFHQFULLntmeBASICV2TRAINUP", tvfhq.VFHQTrainDataset),
                      ("VFHQFULLntmeBASICV2TESTUP", tvfhq.VFHQTestDataset),
                      ("VFHQFULLntmeBASICV2TESTUPROTATE", tvfhq.VFHQRotateTestDataset)):
        assert DATASET_REGISTRY.get(name) is cls


def test_clip_batches_match(vfhq_tree):
    kw = dict(output_dtype="uint8")
    ours = list(tvfhq.clip_batches(tvfhq.VFHQTrainDataset(vfhq_tree, **kw), 2, shuffle=True,
                                   seed=4, drop_last=False))
    ref = list(jvfhq.clip_batches(jvfhq.VFHQTrainDataset(vfhq_tree, **kw), 2, shuffle=True,
                                  seed=4, drop_last=False))
    assert len(ours) == len(ref) == 4
    for a, b in zip(ours, ref):
        _eq(a, b)


# -- loader --------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sync", "thread", "process"])
def test_prefetch_loader_matches_jax_over_two_epochs(vfhq_tree, backend):
    """Two epochs of batches equal the JAX loader's with reseed_dataset=True
    (fresh degradations each epoch); the port's loader never writes the
    dataset's seed, the JAX one does.  The port's process backend (spawned
    workers, the dataset pickled to them) is held to the JAX loader's sync
    backend, which spawns no process that would import JAX."""
    kw = dict(output_dtype="uint8", seed=5)
    t_ds, j_ds = tvfhq.VFHQTrainDataset(vfhq_tree, **kw), jvfhq.VFHQTrainDataset(vfhq_tree, **kw)
    lkw = dict(batch_size=2, shuffle=True, seed=1, num_workers=2, prefetch=1, backend=backend,
               keys=("gt", "lq"), reseed_dataset=True)
    ours = tloader.PrefetchLoader(t_ds, **lkw)
    ref = jloader.PrefetchLoader(j_ds, **{**lkw, "backend": "sync" if backend == "process"
                                          else backend})
    assert len(ours) == len(ref) == 3
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _eq(a, b)
        epochs.append(got)
        assert t_ds.seed == 5
    assert j_ds.seed == 5 + 100003
    # the second epoch drew fresh degradations
    assert any(not np.array_equal(a["lq"], b["lq"]) for a, b in zip(*epochs))
    assert len(ours.load_seconds) == 6


def test_prefetch_loader_seek_continues_the_epoch(vfhq_tree):
    """A loader seeked to step k yields what an uninterrupted loader yields
    after its first k batches, across the epoch boundary."""
    kw = dict(batch_size=2, shuffle=True, seed=2, backend="sync", keys=("gt",),
              reseed_dataset=True)
    ds = tvfhq.VFHQTrainDataset(vfhq_tree, output_dtype="uint8")
    full = tloader.PrefetchLoader(ds, **kw)
    stream = [b for _ in range(3) for b in full]
    for k in (2, 3, 4):
        resumed = tloader.PrefetchLoader(ds, **kw)
        resumed.seek(full.position_at(k))
        assert (resumed.epoch, resumed.skip) == divmod(k, 3)
        got = [b for _ in range(3) for b in resumed][:9 - k]
        assert len(got) == 9 - k
        for a, b in zip(got, stream[k:]):
            _eq(a, b)


def test_device_prefetch_order_and_errors():
    """device_prefetch yields in order, applies put(), and propagates
    iterator errors to the consumer; closing it stops its thread."""
    import threading
    out = list(tloader.device_prefetch(iter(range(7)), lambda x: x * 10, depth=2))
    assert out == [0, 10, 20, 30, 40, 50, 60]

    def bad():
        yield 1
        raise RuntimeError("loader died")

    it = tloader.device_prefetch(bad(), lambda x: x, depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="loader died"):
        list(it)

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = tloader.device_prefetch(endless(), lambda x: x, depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed.wait(5.0)


def test_upload_fn_on_the_cpu():
    import torch
    put = tloader.upload_fn("cpu")
    b = put({"gt": np.arange(6, dtype=np.uint8).reshape(2, 3), "lq": np.ones(2, np.float32)})
    assert isinstance(b["gt"], torch.Tensor) and b["gt"].dtype == torch.uint8
    assert b["gt"].tolist() == [[0, 1, 2], [3, 4, 5]] and b["lq"].dtype == torch.float32


# -- metrics and image helpers --------------------------------------------------

@pytest.mark.parametrize("crop,y", [(0, False), (3, False), (0, True), (2, True)])
def test_psnr_ssim_match(crop, y):
    from pgtformer_tpu.eval import metrics as jm
    from pgtformer_tpu_torch.eval import metrics as tm
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for f in ("calculate_psnr", "calculate_ssim"):
        got = getattr(tm, f)(a, b, crop_border=crop, test_y_channel=y)
        want = getattr(jm, f)(a, b, crop_border=crop, test_y_channel=y)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert tm.calculate_psnr(a, a) == float("inf")


def test_img_helpers_and_alignment_match():
    from pgtformer_tpu.data import align as jal
    from pgtformer_tpu.utils import img as jimg
    from pgtformer_tpu_torch.data import align as tal
    from pgtformer_tpu_torch.utils import img as timg
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    ok, png = cv2.imencode(".png", u8)
    for flag in ("color", "grayscale", "unchanged"):
        for f32 in (False, True):
            _eq(timg.imfrombytes(png.tobytes(), flag, f32), jimg.imfrombytes(png.tobytes(), flag, f32))
    f = rng.uniform(-0.1, 1.1, (5, 4, 3))
    _eq(timg.img2array(u8), jimg.img2array(u8))
    _eq(timg.array2img(f), jimg.array2img(f))
    lm = jal.FACE_TEMPLATE_512 / 8 + rng.normal(0, 1, (5, 2))
    for scale in (1.0, 4.0):
        m = tal.estimate_alignment(lm, scale)
        _eq(m, jal.estimate_alignment(lm, scale))
        _eq(tal.warp_to_template(u8, m, (64, 64), scale), jal.warp_to_template(u8, m, (64, 64), scale))
