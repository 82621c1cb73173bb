"""The plain float32 references held to the port's CPU path, in float32, at
the small geometries: the same weights give the same numbers."""

import numpy as np
import torch

from conftest import SMALL_CF, small_spec
from reference import layers as L
from reference.codeformer import CodeFormer as RefCodeFormer, restore_faces
from reference.pgtformer import PGTFormer as RefPGTFormer, chunk_context, serve_chunk
from weights import make_state_dict


def _weights(ref_cls, cfg, seed=7, dtype=torch.float32):
    with torch.device("meta"):
        shapes = L.key_shapes(ref_cls(cfg))
    spec_rules = {"gain": {".scale.2.": 0.25, ".shift.2.": 0.25}}
    return make_state_dict(shapes, seed, spec_rules, dtype, "cpu")


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def test_pgtformer_stages_match_the_port():
    from pgtformer_tpu_torch.config import PGTFormerConfig
    from pgtformer_tpu_torch.convert import load_into
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    cfg = small_spec("pgt-video-b8").config["model"]
    sd = _weights(RefPGTFormer, cfg)
    port = load_into(PGTFormer(PGTFormerConfig.from_dict(cfg)), sd).eval()
    ref = L.load_reference(RefPGTFormer(cfg), sd, "cpu")
    x = torch.rand(6, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        pos, trunk, feats = port.encode_frames(x)
        got = [pos, trunk, *feats]
        want = ref.encode_frames(x)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and _rel(a, b) < 1e-5
        idx = torch.stack([torch.arange(i, i + 3) for i in range(4)])
        out = port.restore_windows(pos[idx], trunk[idx], tuple(f[idx] for f in feats),
                                   w=1.0, middle_only=True)[0]
        want = ref.restore_windows([f[idx] for f in want], 1.0, True)
    assert out.shape == want.shape == (4, 32, 32, 3)
    assert _rel(out, want) < 1e-5


def test_serving_step_matches_the_restorer_across_chunks():
    """serve_chunk, its context worked out from the clip, against
    VideoRestorer's prime and carried tail over a whole clip (the last
    call padded), in float32."""
    from pgtformer_tpu_torch.config import PGTFormerConfig
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    import traffic
    cfg = small_spec("pgt-video-b8").config["model"]
    sd = _weights(RefPGTFormer, cfg, seed=8)
    vr = VideoRestorer(weights=sd, cfg=PGTFormerConfig.from_dict(cfg), w=1.0, batch_windows=4,
                       dtype=torch.float32, device="cpu")
    ref = L.load_reference(RefPGTFormer(cfg), sd, "cpu")
    L_frames = 11
    frames = traffic.make_frames(3, L_frames, 32, "cpu")
    vr.prime(frames[0])
    plan = traffic.clip_plan(L_frames, 4, vr.radius)
    assert [n for _, n in plan] == [4, 4, 3]
    for k, (idx, n) in enumerate(plan):
        got = vr.restore_chunk(frames[list(idx)]).numpy()[:n]
        ctx = chunk_context(k, 4, L_frames, vr.radius)
        want = serve_chunk(ref, torch.from_numpy(frames[ctx]), 1.0, True).numpy()[:n]
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, (k, d.max(), (d > 0).mean())


def test_codeformer_matches_the_port():
    from pgtformer_tpu_torch.convert import load_into
    from pgtformer_tpu_torch.models.codeformer import CodeFormer
    cfg = dict(SMALL_CF)
    sd = _weights(RefCodeFormer, cfg, seed=9)
    tables = {k: v for k, v in cfg.items() if k.isupper()}
    port_cls = type("CodeFormer", (CodeFormer,), tables)
    port = load_into(port_cls(**{k: v for k, v in cfg.items() if not k.isupper()}), sd).eval()
    ref = L.load_reference(RefCodeFormer(cfg), sd, "cpu")
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    with torch.no_grad():
        for w, adain in ((0.5, True), (0.0, False)):
            got = port(x, w=w, adain=adain)[0]
            want = ref(x, w, adain)
            assert got.shape == want.shape and _rel(got, want) < 1e-5
        faces = ((x + 1) * 127.5).round().to(torch.uint8)
        a = restore_faces(ref, faces, 0.5, True)
        b = ((port(faces.float() / 127.5 - 1.0, w=0.5, adain=True)[0].clamp(-1, 1) + 1)
             * 127.5).round().to(torch.uint8)
    assert (a.int() - b.int()).abs().max() <= 1


def test_release_configuration_is_the_ports():
    """The configuration file runs RELEASE_PGTFORMER, and the reference's
    state dict has the port's keys and shapes at the published widths."""
    from pgtformer_tpu_torch.config import PGTFormerConfig, RELEASE_PGTFORMER
    from pgtformer_tpu_torch.models.codeformer import CodeFormer
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    import harness
    pgt = harness.load_spec("pgt-video-b8").config
    assert PGTFormerConfig.from_dict(pgt["model"]) == RELEASE_PGTFORMER
    cf = harness.load_spec("codeformer-faces-b16").config
    with torch.device("meta"):
        pairs = ((PGTFormer(RELEASE_PGTFORMER), RefPGTFormer(pgt["model"])),
                 (CodeFormer(**cf["model"]), RefCodeFormer(cf["model"])))
        for port, ref in pairs:
            port_keys = {k: tuple(v.shape) for k, v in port.state_dict().items()}
            assert port_keys == dict(L.key_shapes(ref))
