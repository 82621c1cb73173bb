"""The port's face metrics against the JAX package's: the landmark fallbacks
(`eval/landmarks.py`) and the ArcFace IResNet (`eval/arcface.py`).

Tolerances:
- `landmarks_from_parsing`, `msrl`, `GrayPatchEmbedder` and
  `face_metrics_frame` (stub detector) are the same numpy/cv2 code in both
  packages: bit for bit.
- `ParserLandmarkDetector` runs the same seeded parser weights in fp32 in
  both packages: the class maps must be equal except at near-ties, cells
  where JAX's top two logits lie within 1e-4 of the logits' largest
  magnitude (summation order decides those); the landmarks of every image
  whose maps are equal must be equal.
- IResNet / `ArcFaceEmbedder` (fp32): within 1e-4 relative, and 1e-4 of
  the embedding's largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pgtformer_tpu.eval.landmarks as JL
import pgtformer_tpu.eval.arcface as JA
import pgtformer_tpu_torch.eval.landmarks as TL
import pgtformer_tpu_torch.eval.arcface as TA
from pgtformer_tpu_torch.convert import flax_to_state_dict
from tests.test_torch_common import one_torch_thread, small_pgt  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY = (1, 1, 1, 1)
NEAR_TIE = 1e-4


def _synthetic_parsing(h=64, w=64):
    m = np.zeros((h, w), np.int64)
    m[20:24, 16:22] = JL.CLS_L_EYE
    m[20:24, 42:48] = JL.CLS_R_EYE
    m[32:38, 30:34] = JL.CLS_NOSE
    m[46:50, 22:42] = JL.CLS_MOUTH[1]
    m[48:50, 20:22] = JL.CLS_MOUTH[2]
    return m


@pytest.mark.parametrize("case", ["synthetic", "random", "empty", "wide"])
def test_landmarks_from_parsing_matches_jax(case):
    rng = np.random.default_rng(0)
    m = {"synthetic": _synthetic_parsing(), "random": rng.integers(0, 19, (64, 64)),
         "empty": np.zeros((64, 64), np.int64),
         "wide": rng.integers(0, 19, (32, 48))}[case]
    for size in (512, 112.0, 37):
        np.testing.assert_array_equal(TL.landmarks_from_parsing(m, size),
                                      JL.landmarks_from_parsing(m, size))


def test_msrl_and_gray_patch_match_jax():
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 1, (128, 112, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.05, size=gt.shape), 0, 1).astype(np.float32)
    lm = np.array([[40, 40], [90, 40], [64, 64], [3, 120], [110, 2]], np.float64)
    for crop, scales in ((32, (1.0, 0.5, 0.25)), (64, (1.0, 0.5)), (16, (1.0,))):
        assert TL.msrl(pred, gt, lm, crop, scales) == JL.msrl(pred, gt, lm, crop, scales)
    assert TL.msrl(gt, gt, lm) == JL.msrl(gt, gt, lm) == float("inf")
    for img in (gt, pred[:70]):
        np.testing.assert_array_equal(TL.GrayPatchEmbedder()(img), JL.GrayPatchEmbedder()(img))


def test_face_metrics_frame_matches_jax():
    rng = np.random.default_rng(2)
    gt = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.02, size=gt.shape), 0, 1).astype(np.float32)
    pts = np.array([[20, 20], [44, 20], [32, 34], [24, 46], [40, 46]], np.float64)
    det = lambda img: pts + 3.0 * float(img.mean() > gt.mean())
    ours = TL.face_metrics_frame(pred, gt, det, TL.GrayPatchEmbedder())
    ref = JL.face_metrics_frame(pred, gt, det, JL.GrayPatchEmbedder())
    assert ours.keys() == ref.keys() == {"deg", "lmd", "msrl", "_lm_pred", "_lm_gt"}
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def parsers(small_pgt):
    """The JAX detector and the port's (from the module, and from the
    `conditionnet` sub-state-dict), on a seeded PGTFormer's parser."""
    from pgtformer_tpu.models.parser import BiSeNet
    from pgtformer_tpu.ops.image import imagenet_normalize
    _, v, model, _ = small_pgt
    cond = {col: v[col]["conditionnet"] for col in ("params", "batch_stats")}
    prior = jax.jit(lambda img: BiSeNet(out_hw=(64, 64)).apply(
        cond, imagenet_normalize(img[None]))[0, :, :, :19])
    sub = {k[len("conditionnet."):]: a for k, a in flax_to_state_dict(v).items()
           if k.startswith("conditionnet.")}
    return (JL.ParserLandmarkDetector(cond), prior,
            TL.ParserLandmarkDetector(model.conditionnet, device="cpu"),
            TL.ParserLandmarkDetector(sub, device="cpu"))


def test_parser_landmark_detector_matches_jax(parsers):
    jdet, jprior, tdet, tdet_sd = parsers
    rng = np.random.default_rng(3)
    equal_maps = 0
    for _ in range(3):
        img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
        ours, ref = tdet.class_map(img), np.asarray(jdet._cls_map(img))
        assert ours.shape == ref.shape == (64, 64)
        np.testing.assert_array_equal(tdet_sd.class_map(img), ours)
        differ = ours != ref
        if differ.any():
            logits = np.sort(np.asarray(jprior(img)), axis=-1)
            gap = logits[..., -1] - logits[..., -2]
            assert (gap[differ] <= NEAR_TIE * np.abs(logits).max()).all()
        else:
            equal_maps += 1
            lm = tdet(img)
            assert lm.shape == (5, 2)
            np.testing.assert_array_equal(lm, jdet(img))
            np.testing.assert_array_equal(tdet_sd(img), lm)
    assert equal_maps >= 2


def test_parser_landmark_detector_keeps_the_models_parser(small_pgt):
    """The detector runs a second BiSeNet at its own grid; the PGTFormer's
    parser keeps its latent-size head and its weights."""
    _, _, model, _ = small_pgt
    before = {k: a.clone() for k, a in model.conditionnet.state_dict().items()}
    det = TL.ParserLandmarkDetector(model.conditionnet, grid=48, device="cpu")
    assert det.net is not model.conditionnet and det.net.out_hw == (48, 48)
    assert model.conditionnet.out_hw == (16, 16)
    for k, a in model.conditionnet.state_dict().items():
        assert torch.equal(a, before[k]) and torch.equal(det.net.state_dict()[k], a)


# -- ArcFace ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_arcface():
    """JAX's IResNet(layers=(1,1,1,1)) from its own init, with seeded
    non-trivial BatchNorm statistics, affines and PReLU slopes; the same
    weights as an arcface_torch state dict."""
    model = JA.IResNet(layers=TINY)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3), jnp.float32))
    rng = np.random.default_rng(4)

    def perturb(path, a):
        name = path[-1].key
        a = np.asarray(a)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if name in ("mean", "bias"):
            return (rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        if name in ("scale", "alpha"):
            return (a + rng.normal(size=a.shape) * 0.1).astype(a.dtype)
        return a

    v = jax.tree_util.tree_map_with_path(perturb, v)
    return model, v, TA.arcface_state_dict_from_flax(v)


def _faces(seed, n=2, size=112):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _close(ours, ref):
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_iresnet_matches_jax(tiny_arcface):
    model, v, sd = tiny_arcface
    net = TA.IResNet(TINY)
    net.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, strict=True)
    x = _faces(5)
    with torch.no_grad():
        ours = net.eval()(torch.from_numpy(x)).numpy()
    ref = np.asarray(model.apply(v, jnp.asarray(x)))
    assert ours.shape == ref.shape == (2, 512)
    _close(ours, ref)


def test_state_dict_passes_jax_strict_porter(tiny_arcface):
    """The port's keys are arcface_torch's: JAX's strict porter consumes the
    port's state dict (with the `num_batches_tracked` a released file
    carries) and gives back the variables it came from; at full depth
    (IResNet-50) it fills every leaf of JAX's variables with the right
    shapes."""
    model, v, sd = tiny_arcface
    net = TA.IResNet(TINY)
    net.load_state_dict({k: torch.from_numpy(a) for k, a in sd.items()}, strict=True)
    released = {k: a.numpy() for k, a in net.state_dict().items()}
    released.update({k[:-len("running_mean")] + "num_batches_tracked": np.array(7)
                     for k in list(released) if k.endswith("running_mean")})
    back = JA.port_arcface_torch_weights(v, released, strict=True)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                jax.tree_util.tree_leaves_with_path(v)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(pa))
    full = jax.eval_shape(lambda: JA.IResNet(layers=TA.IRESNET50_LAYERS).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3), jnp.float32)))
    sd50 = {k: a.numpy() for k, a in TA.IResNet(TA.IRESNET50_LAYERS).state_dict().items()}
    ported = JA.port_arcface_torch_weights(full, sd50, strict=True)
    assert jax.tree.structure(ported) == jax.tree.structure(full)


def test_strict_load_refuses_missing_and_extra_keys(tiny_arcface):
    _, _, sd = tiny_arcface
    missing = {k: a for k, a in sd.items() if k != "fc.weight"}
    with pytest.raises(RuntimeError, match="fc.weight"):
        TA.ArcFaceEmbedder(torch_state_dict=missing, layers=TINY, device="cpu")
    extra = dict(sd, **{"unexpected.weight": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="unexpected.weight"):
        TA.ArcFaceEmbedder(torch_state_dict=extra, layers=TINY, device="cpu")
    with_counts = dict(sd, **{"bn1.num_batches_tracked": np.array(3)})
    TA.ArcFaceEmbedder(torch_state_dict=with_counts, layers=TINY, device="cpu")


@pytest.mark.parametrize("aligned", [False, True])
def test_arcface_embedder_matches_jax(tiny_arcface, tmp_path, aligned):
    """The embedder end to end (the cv2 crop: similarity alignment to the
    template from a stub detector, or an INTER_AREA resize; the (x-0.5)/0.5
    normalization; the forward) against JAX's, the weights from a file."""
    _, _, sd = tiny_arcface
    path = str(tmp_path / "backbone.pth")
    torch.save({k: torch.from_numpy(a) for k, a in sd.items()}, path)
    pts = np.array([[20, 24], [44, 24], [32, 36], [24, 46], [40, 46]], np.float64)
    det = (lambda im: pts) if aligned else None
    ours = TA.ArcFaceEmbedder(path, detector=det, layers=TINY, device="cpu")
    ref = JA.ArcFaceEmbedder(detector=det, layers=TINY, torch_state_dict=sd)
    assert not ours.random_weights
    rng = np.random.default_rng(6)
    for shape in ((64, 64, 3), (80, 72, 3)):
        img = rng.uniform(0, 1, shape).astype(np.float32)
        e = ours(img)
        assert e.shape == (512,) and e.dtype == np.float32
        _close(e, ref(img))


def test_arcface_embedder_random_default(capsys):
    a = TA.ArcFaceEmbedder(layers=TINY, device="cpu")
    assert a.random_weights and "RANDOM weights" in capsys.readouterr().err
    b = TA.ArcFaceEmbedder(layers=TINY, device="cpu", warn_random=False)
    assert "WARNING" not in capsys.readouterr().err
    img = np.random.default_rng(7).uniform(0, 1, (64, 64, 3)).astype(np.float32)
    np.testing.assert_array_equal(a(img), b(img))
    assert np.isfinite(a(img)).all()
