"""The port's VMAF (`pgtformer_tpu_torch/eval/vmaf.py`) against the JAX
package's on seeded frames.  Both are the same numpy, so every feature and
score agrees to 1e-9; the vendored model JSON is byte-identical, and
`$PGT_VMAF_MODEL` picks the model file."""

import importlib
import os
from pathlib import Path

import numpy as np
import pytest

import pgtformer_tpu.eval.vmaf as J
import pgtformer_tpu_torch.eval.vmaf as T

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-9


def _pair(seed, hw=64):
    """(ref, dis) RGB in [0, 1]: a smooth image and a noisy, blurred copy."""
    import cv2
    rng = np.random.default_rng(seed)
    ref = cv2.resize(rng.uniform(0, 1, (hw // 8, hw // 8, 3)), (hw, hw),
                     interpolation=cv2.INTER_CUBIC)
    ref = np.clip(ref + rng.normal(0, 0.02, ref.shape), 0, 1)
    dis = np.clip(cv2.GaussianBlur(ref, (3, 3), 0.8) + rng.normal(0, 0.03, ref.shape), 0, 1)
    return ref, dis


def test_vendored_model_byte_identical():
    ours = REPO / "pgtformer_tpu_torch" / "eval" / "models" / "vmaf_v0.6.1.json"
    ref = REPO / "pgtformer_tpu" / "eval" / "models" / "vmaf_v0.6.1.json"
    assert ours.read_bytes() == ref.read_bytes()
    assert Path(T._VENDORED_MODEL) == ours
    assert T.available()


@pytest.mark.parametrize("seed,hw", [(0, 64), (1, 48), (2, 96)])
def test_features_match_jax(seed, hw):
    ref, dis = _pair(seed, hw)
    r, d = T.rgb_to_luma(ref), T.rgb_to_luma(dis)
    np.testing.assert_allclose(r, J.rgb_to_luma(ref), rtol=0, atol=TOL)
    np.testing.assert_allclose(T.vif_features(r, d), J.vif_features(r, d), rtol=0, atol=TOL)
    assert abs(T.adm_feature(r, d) - J.adm_feature(r, d)) <= TOL
    m_t, blur_t = T.motion_feature(None, r, None)
    m_j, blur_j = J.motion_feature(None, r, None)
    assert m_t == m_j == 0.0
    np.testing.assert_allclose(blur_t, blur_j, rtol=0, atol=TOL)
    m_t, _ = T.motion_feature(blur_t, d, None)
    m_j, _ = J.motion_feature(blur_j, d, None)
    assert abs(m_t - m_j) <= TOL


def test_model_matches_jax():
    ours, ref = T.VmafModel(), J.VmafModel()
    assert ours.feature_names == ref.feature_names
    np.testing.assert_array_equal(ours.svs, ref.svs)
    np.testing.assert_array_equal(ours.sv_coef, ref.sv_coef)
    assert (ours.gamma, ours.rho, ours.norm_type, ours.score_clip) == \
        (ref.gamma, ref.rho, ref.norm_type, ref.score_clip)
    feats = {"adm2": 0.93, "motion2": 3.1, "motion": 3.1, "vif_scale0": 0.6,
             "vif_scale1": 0.8, "vif_scale2": 0.85, "vif_scale3": 0.9}
    assert abs(ours.predict(feats) - ref.predict(feats)) <= TOL


def test_scorer_matches_jax():
    """Per-frame scores over a 4-frame stream (motion2 from both
    neighbours) and their mean."""
    ours, ref = T.VmafScorer(), J.VmafScorer()
    for seed in range(4):
        a, b = _pair(10 + seed)
        ours.update(a, b)
        ref.update(a, b)
    s_t, s_j = ours.finish(), ref.finish()
    assert len(s_t) == len(s_j) == 4
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=TOL)
    assert abs(ours.mean() - ref.mean()) <= TOL
    assert all(0.0 <= s <= 100.0 for s in s_t)


def test_env_selects_model(monkeypatch, tmp_path):
    path = str(tmp_path / "model.json")
    monkeypatch.setenv("PGT_VMAF_MODEL", path)
    try:
        mod = importlib.reload(T)
        assert mod.DEFAULT_MODEL == path and not mod.available()
        with open(path, "wb") as f:
            f.write(Path(mod._VENDORED_MODEL).read_bytes())
        assert mod.available()
        assert mod.VmafScorer().model.feature_names == J.VmafModel().feature_names
    finally:
        monkeypatch.delenv("PGT_VMAF_MODEL")
        mod = importlib.reload(T)
    assert mod.DEFAULT_MODEL == mod._VENDORED_MODEL
    assert os.environ.get("PGT_VMAF_MODEL") is None
