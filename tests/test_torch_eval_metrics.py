"""The port's evaluation metrics against the JAX package's: the pure-math
metrics (LMD, TLME, Deg, `evaluate_clip`), NIQE and LPIPS.

Tolerances: the pure-math metrics and NIQE are the same numpy/cv2 code in
both packages, so they must agree bit for bit.  LPIPS runs the same seeded
`lpips.LPIPS(net='vgg')` state dict through the JAX package's flax VGG and
the port's torch VGG in fp32: within 1e-5 relative (summation order).
"""

import numpy as np
import pytest
import torch

import pgtformer_tpu.eval.metrics as JM
import pgtformer_tpu.eval.niqe as JN
import pgtformer_tpu_torch.eval.metrics as TM
import pgtformer_tpu_torch.eval.niqe as TN
from tests.test_torch_common import one_torch_thread, small_lpips  # noqa: F401
from tests.test_torch_train_parts import _lpips_layout

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _images(seed, shape, n=2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, shape).astype(np.float32) for _ in range(n)]


def test_eval_package_exports_match_jax():
    import pgtformer_tpu.eval as je
    import pgtformer_tpu_torch.eval as te
    names = [n for n in vars(je) if not n.startswith("_") and callable(getattr(je, n))]
    assert names and all(callable(getattr(te, n, None)) for n in names), names


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_landmark_and_identity_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    lm_p, lm_g = rng.uniform(0, 512, (2, 5, 2))
    assert TM.landmark_distance(lm_p, lm_g) == JM.landmark_distance(lm_p, lm_g)
    seq_p, seq_g = rng.uniform(0, 512, (2, 4, 5, 2))
    assert (TM.temporal_landmark_error(seq_p, seq_g)
            == JM.temporal_landmark_error(seq_p, seq_g))
    e_p, e_g = rng.normal(size=(2, 512)).astype(np.float32)
    for a, b in ((e_p, e_g), (e_p, e_p), (e_p, -e_p)):
        assert TM.identity_degradation(a, b) == JM.identity_degradation(a, b)


@pytest.mark.parametrize("with_lpips", [False, True])
def test_evaluate_clip_matches_jax(with_lpips):
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (3, 48, 40, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.05, size=gt.shape), 0, 1).astype(np.float32)
    stub = (lambda a, b: float(np.abs(a - b).mean())) if with_lpips else None
    ours, ref = TM.evaluate_clip(pred, gt, stub), JM.evaluate_clip(pred, gt, stub)
    assert ours.keys() == ref.keys() == ({"psnr", "ssim", "lpips"} if with_lpips
                                         else {"psnr", "ssim"})
    for k in ref:
        assert ours[k] == ref[k], k


# -- NIQE -----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rgb", "gray", "rgb_crop"])
def test_niqe_features_match_jax(kind):
    img = _images(4, (192, 224, 3) if kind != "gray" else (192, 200), n=1)[0]
    crop = 8 if kind == "rgb_crop" else 0
    ours = TN.image_niqe_features(img, crop)
    ref = JN.image_niqe_features(img, crop)
    assert ours.shape == ref.shape and ours.shape[1] == 36
    np.testing.assert_array_equal(ours, ref)


def test_niqe_fit_and_score_match_jax(tmp_path):
    """`fit_pris_params` on a corpus of 192x192 images, `niqe_from_features`
    against it, and `calculate_niqe` through an .npz written here (with and
    without a `gaussian_window`)."""
    imgs = _images(5, (192, 192, 3), n=4)
    feats = [JN.image_niqe_features(im) for im in imgs]
    mu_t, cov_t = TN.fit_pris_params(feats)
    mu_j, cov_j = JN.fit_pris_params(feats)
    np.testing.assert_array_equal(mu_t, mu_j)
    np.testing.assert_array_equal(cov_t, cov_j)
    score = TN.niqe_from_features(feats[0], mu_j, cov_j)
    assert np.isfinite(score) and score == JN.niqe_from_features(feats[0], mu_j, cov_j)
    noisy = np.clip(imgs[0] + np.random.default_rng(6).normal(scale=0.2, size=imgs[0].shape),
                    0, 1)
    for window in (False, True):
        path = str(tmp_path / f"pris_{window}.npz")
        extra = {"gaussian_window": TN._gaussian_window(7, 1.5)} if window else {}
        np.savez(path, mu_pris_param=mu_j, cov_pris_param=cov_j, **extra)
        for im in (imgs[1], noisy):
            assert TN.calculate_niqe(im, path) == JN.calculate_niqe(im, path)


def test_niqe_aggd_edge_cases_match_jax():
    rng = np.random.default_rng(7)
    for block in (rng.normal(size=(96, 96)), np.abs(rng.normal(size=(48, 48))),
                  -np.abs(rng.normal(size=(48, 48)))):
        assert TN.estimate_aggd_param(block) == JN.estimate_aggd_param(block)
        assert TN.compute_feature(block) == JN.compute_feature(block)


# -- LPIPS ----------------------------------------------------------------------

def test_calculate_lpips_fn_matches_jax(tmp_path):
    """The same lpips-layout state dict given to both, as a dict and as a
    file; [0, 1] HWC numpy images in, a float out."""
    sd = _lpips_layout(small_lpips(seed=11)[2])
    path = str(tmp_path / "lpips_vgg.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    jfn = JM.calculate_lpips_fn(torch_state_dict=sd)
    tfn = TM.calculate_lpips_fn(weights_path=path, device="cpu")
    tfn_sd = TM.calculate_lpips_fn(
        torch_state_dict={k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        device="cpu")
    assert not jfn.random_weights and not tfn.random_weights
    a, b = _images(8, (64, 48, 3))
    for x, y in ((a, b), (a, np.clip(a + 0.01, 0, 1))):
        ref = jfn(x, y)
        assert isinstance(tfn(x, y), float)
        np.testing.assert_allclose(tfn(x, y), ref, rtol=1e-5)
        assert tfn_sd(x, y) == tfn(x, y)
    assert tfn(a, a) == 0.0


def test_calculate_lpips_fn_random_default(capsys):
    fn = TM.calculate_lpips_fn(device="cpu")
    assert fn.random_weights and "RANDOM VGG" in capsys.readouterr().err
    a, b = _images(9, (32, 32, 3))
    assert fn(a, b) == TM.calculate_lpips_fn(device="cpu")(a, b) > 0

