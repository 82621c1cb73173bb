"""The fused decoder tail of the PyTorch port (ops/fused_conv.py, kernels K7
and K8, knob FUSED_TAIL) against the JAX package, on the CPU.

The JAX kernels run in Pallas interpret mode, as tests/test_pallas_conv.py
runs them; the port runs its plain versions (on the CPU a wrapper takes the
plain version because the tensor lies on the CPU).  Inputs and weights are
seeded numpy arrays.  Tolerances:

* channel_stats, gn_affine_from_stats, phase_kernels_2x2: fp32, rtol 1e-5
  (summation order);
* gn_silu_conv3x3 / subpixel_up_conv3x3: atol = rtol = 2e-2 on the bf16
  output (one bf16 ulp where fp32 sums in another order round the other
  way), stats rtol 1e-3 (sums of such outputs);
* fused_decoder_tail: max|d| < 5e-2, mean|d| < 5e-3 (the JAX test's limits
  for the chain against the stock modules);
* Decoder3D in bf16 with the knob set against the JAX Decoder3D's XLA path
  in bf16: mean|d| <= 1e-2 * max|ref| and max|d| <= 1e-1 * max|ref| (two
  bf16 towers that round at different places).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.config as jcfg
import pgtformer_tpu.models.vae as jvae
import pgtformer_tpu.ops.pallas_conv as jpc
import pgtformer_tpu_torch.config as tcfg
import pgtformer_tpu_torch.models.vae as tvae
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.ops.fused_conv as fc
from pgtformer_tpu_torch import knobs
from tests.test_torch_common import close, japply, random_variables, t, to_port

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    monkeypatch.delenv("PGT_FUSED_TAIL", raising=False)
    knobs.reset()
    yield
    knobs.reset()


def _rand(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _np32(x: torch.Tensor):
    return x.float().numpy()


# -- the plain helpers -----------------------------------------------------------

def test_channel_stats_matches_jax():
    x = _rand(np.random.default_rng(0), (2, 6, 10, 64))
    close(fc.channel_stats(t(x)), jpc.channel_stats(jnp.asarray(x)), atol=0, rtol=1e-5)
    assert fc.channel_stats(t(x).to(BF16)).dtype == torch.float32


@pytest.mark.parametrize("C", [64, 128])
def test_gn_affine_from_stats_matches_jax(C):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 8, 16, C)) + 0.3
    gamma, beta = 1.0 + 0.1 * _rand(rng, (C,)), 0.1 * _rand(rng, (C,))
    a, b = fc.gn_affine_from_stats(fc.channel_stats(t(x)), t(gamma), t(beta), 8 * 16)
    ja, jb = jpc.gn_affine_from_stats(jpc.channel_stats(jnp.asarray(x)), jnp.asarray(gamma),
                                      jnp.asarray(beta), 8 * 16)
    close(a, ja, atol=1e-6, rtol=1e-5)
    close(b, jb, atol=1e-6, rtol=1e-5)
    # the folded affine is the port's GroupNorm
    gn = tb.GroupNorm(C)
    with torch.no_grad():
        gn.weight.copy_(t(gamma))
        gn.bias.copy_(t(beta))
        close(t(x) * a[:, None, None] + b[:, None, None], gn(t(x)), atol=2e-5, rtol=1e-4)


def test_phase_kernels_2x2_matches_jax():
    k3 = _rand(np.random.default_rng(2), (3, 3, 16, 24))
    k2 = fc.phase_kernels_2x2(t(k3))
    assert k2.shape == (2, 2, 2, 2, 16, 24) and k2.dtype == torch.float32
    close(k2, jpc.phase_kernels_2x2(jnp.asarray(k3)), atol=0, rtol=1e-5)
    assert fc.phase_kernels_2x2(t(k3).to(BF16)).dtype == torch.float32


# -- K7 ----------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["plain", "shortcut", "residual", "no_activation"])
def test_gn_silu_conv3x3_plain_matches_jax_kernel(form):
    rng = np.random.default_rng(3)
    N, H, W, C, Co = 2, 16, 32, 64, 32
    x = _rand(rng, (N, H, W, C), 0.5)
    k = _rand(rng, (3, 3, C, Co), 0.05)
    bias = _rand(rng, (Co,), 0.1)
    stats = jpc.channel_stats(jnp.asarray(x))
    gamma, beta = 1.0 + 0.1 * _rand(rng, (C,)), 0.1 * _rand(rng, (C,))
    ja, jb = jpc.gn_affine_from_stats(stats, jnp.asarray(gamma), jnp.asarray(beta), H * W)
    jab = None if form == "no_activation" else (ja, jb)
    tab = None if form == "no_activation" else (t(ja), t(jb))
    jkw, tkw = {}, {}
    if form == "shortcut":
        xs, sk = _rand(rng, (N, H, W, 48), 0.5), _rand(rng, (48, Co), 0.05)
        sb = _rand(rng, (Co,), 0.1)
        jkw["shortcut"] = tuple(jnp.asarray(a) for a in (xs, sk, sb))
        tkw["shortcut"] = (t(xs), t(sk), t(sb))
    if form == "residual":
        res = _rand(rng, (N, H, W, Co), 0.5)
        jkw["residual"], tkw["residual"] = jnp.asarray(res), t(res)
    want, want_st = jpc.gn_silu_conv3x3(jnp.asarray(x), jab, jnp.asarray(k), jnp.asarray(bias),
                                        bh=4, interpret=True, **jkw)
    got, got_st = fc.gn_silu_conv3x3_plain(t(x), tab, t(k), t(bias), **tkw)
    assert got.dtype == BF16 and got.shape == (N, H, W, Co)
    np.testing.assert_allclose(_np32(got), _f32(want), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), rtol=1e-3, atol=1e-2)
    # the stats are those of the rounded output
    close(got_st, fc.channel_stats(got), atol=0, rtol=1e-6)
    # the wrapper takes the plain version for a CPU tensor, and counts nothing
    before = fc.gn_silu_conv3x3.launches
    again, st = fc.gn_silu_conv3x3(t(x), tab, t(k), t(bias), emit_stats=False, **tkw)
    assert torch.equal(again, got) and st is None
    assert fc.gn_silu_conv3x3.launches == before


def test_gn_silu_conv3x3_pads_after_the_activation():
    """silu(b) != 0: a border pixel must see zeros, not silu(0*a + b)."""
    C, Co = 8, 8
    x = torch.zeros((1, 4, 4, C))
    a, b = torch.ones((1, C)), torch.full((1, C), 2.0)
    k = torch.ones((3, 3, C, Co))
    out, _ = fc.gn_silu_conv3x3_plain(x, (a, b), k, torch.zeros(Co))
    s = float(torch.nn.functional.silu(torch.tensor(2.0)).to(BF16))
    assert abs(out[0, 1, 1, 0].item() - 9 * C * s) <= 0.01 * 9 * C * s     # interior: 9 taps
    assert abs(out[0, 0, 0, 0].item() - 4 * C * s) <= 0.01 * 4 * C * s     # corner: 4 taps


# -- K8 ----------------------------------------------------------------------------

@pytest.mark.parametrize("emit_stats", [True, False])
def test_subpixel_up_conv3x3_plain_matches_jax_kernel(emit_stats):
    rng = np.random.default_rng(4)
    N, H, W, C = 2, 8, 16, 128
    x = _rand(rng, (N, H, W, C), 0.5)
    k3 = _rand(rng, (3, 3, C, C), 0.03)
    bias = _rand(rng, (C,), 0.1)
    want, want_st = jpc.subpixel_up_conv3x3(jnp.asarray(x), jnp.asarray(k3), jnp.asarray(bias),
                                            emit_stats=emit_stats, bh=4, interpret=True)
    got, got_st = fc.subpixel_up_conv3x3(t(x), t(k3), t(bias), emit_stats=emit_stats)
    assert got.dtype == BF16 and got.shape == (N, 2 * H, 2 * W, C)
    np.testing.assert_allclose(_np32(got), _f32(want), atol=2e-2, rtol=2e-2)
    if emit_stats:
        np.testing.assert_allclose(got_st.numpy(), np.asarray(want_st), rtol=1e-3, atol=1e-2)
    else:
        assert got_st is None and want_st is None
    # derived phase kernels in place of the 3x3 kernel: the same result
    k2 = fc.phase_kernels_2x2(t(k3)).to(BF16)
    assert torch.equal(fc.subpixel_up_conv3x3_plain(t(x), k2, t(bias), emit_stats=False)[0], got)
    # and it is nearest-up2x + conv3x3 (the port's stock Upsample), to bf16 accuracy
    up = tb.Upsample(C)
    with torch.no_grad():
        up.conv.weight.copy_(t(k3).permute(3, 2, 0, 1))
        up.conv.bias.copy_(t(bias))
        stock = up(t(x))
    np.testing.assert_allclose(_np32(got), stock.numpy(), atol=3e-2, rtol=3e-2)


# -- the chain -----------------------------------------------------------------------

def _tail_params(rng, C=128, Co=64):
    def conv(kh, cin, cout):
        return {"kernel": _rand(rng, (kh, kh, cin, cout)) / np.sqrt(kh * kh * cin),
                "bias": _rand(rng, (cout,), 0.05)}

    def norm(c):
        return {"scale": 1.0 + 0.1 * _rand(rng, (c,)), "bias": 0.1 * _rand(rng, (c,))}

    def block(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, cin, cout), "norm2": norm(cout),
             "conv2": conv(3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, cin, cout)
        return p

    return {"conv": conv(3, C, C)}, block(C, Co), block(Co, Co), norm(Co)


def _load_conv(conv: torch.nn.Conv2d, p):
    with torch.no_grad():
        conv.weight.copy_(t(p["kernel"]).permute(3, 2, 0, 1))
        conv.bias.copy_(t(p["bias"]))


def _load_norm(norm, p):
    with torch.no_grad():
        norm.weight.copy_(t(p["scale"]))
        norm.bias.copy_(t(p["bias"]))


def _port_tail_modules(p_up, p_b0, p_b1, p_norm, C=128, Co=64):
    up, b0, b1, gn = tb.Upsample(C), tb.ResnetBlock(C, Co), tb.ResnetBlock(Co), tb.GroupNorm(Co)
    _load_conv(up.conv, p_up["conv"])
    for blk, p in ((b0, p_b0), (b1, p_b1)):
        _load_norm(blk.norm1, p["norm1"])
        _load_conv(blk.conv1, p["conv1"])
        _load_norm(blk.norm2, p["norm2"])
        _load_conv(blk.conv2, p["conv2"])
        if "nin_shortcut" in p:
            _load_conv(blk.nin_shortcut, p["nin_shortcut"])
    _load_norm(gn, p_norm)
    return up, b0, b1, gn


@pytest.fixture(scope="module")
def tail():
    rng = np.random.default_rng(5)
    params = _tail_params(rng)
    h = _rand(rng, (2, 8, 8, 128), 0.5)
    up, b0, b1, gn = _port_tail_modules(*params)
    with torch.no_grad():
        got = fc.fused_decoder_tail(t(h).to(BF16), up.kernel_weights(), b0.kernel_weights(),
                                    b1.kernel_weights(), (gn.weight, gn.bias))
    return params, h, (up, b0, b1, gn), got


def test_fused_decoder_tail_matches_jax_kernels(tail):
    params, h, _, got = tail
    jp = [{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}) for k, v in p.items()}
          for p in params[:3]]
    jnorm = {k: jnp.asarray(v) for k, v in params[3].items()}
    want = jpc.fused_decoder_tail(jnp.asarray(h).astype(jnp.bfloat16), *jp, jnorm,
                                  interpret=True)
    assert got.shape == (2, 16, 16, 64) and got.dtype == BF16
    diff = np.abs(_np32(got) - _f32(want))
    assert diff.max() < 5e-2, diff.max()
    assert diff.mean() < 5e-3, diff.mean()


def test_fused_decoder_tail_matches_the_stock_modules(tail):
    _, h, (up, b0, b1, gn), got = tail
    with torch.no_grad():
        want = torch.nn.functional.silu(gn(b1(b0(up(t(h))))))
    diff = (got.float() - want).abs().numpy()
    assert diff.max() < 5e-2, diff.max()
    assert diff.mean() < 5e-3, diff.mean()


def test_kernel_weight_caches_follow_the_parameters():
    rng = np.random.default_rng(6)
    up, b0, _, _ = _port_tail_modules(*_tail_params(rng, 64, 32), C=64, Co=32)
    k2, bias = up.kernel_weights()
    assert k2.shape == (2, 2, 2, 2, 64, 64) and k2.dtype == BF16 and bias.dtype == torch.float32
    assert up.kernel_weights()[0] is k2                        # cached
    w = b0.kernel_weights()
    assert w.conv1_kernel.shape == (3, 3, 64, 32) and w.conv1_kernel.dtype == BF16
    assert w.shortcut_kernel.shape == (64, 32) and w.norm1_weight.dtype == torch.float32
    close(w.conv1_kernel.float(), b0.conv1.weight.detach().permute(2, 3, 1, 0).to(BF16).float(),
          atol=0, rtol=0)
    assert tb.ResnetBlock(32).kernel_weights().shortcut_kernel is None
    sd = {k: v * 2 for k, v in up.state_dict().items()}
    up.load_state_dict(sd)                                       # a load drops the cache
    assert not torch.equal(up.kernel_weights()[0], k2)
    b0.to(BF16)                                                  # so does a cast
    assert b0.kernel_weights() is not w
    assert set(up.state_dict()) == {"conv.weight", "conv.bias"}  # names do not change


@pytest.mark.parametrize("fn,args", [
    ("gn_silu_conv3x3", lambda: (torch.zeros(2, 4, 64), None, torch.zeros(3, 3, 64, 64),
                                 torch.zeros(64))),
    ("subpixel_up_conv3x3", lambda: (torch.zeros(4, 4, 64), torch.zeros(3, 3, 64, 64),
                                     torch.zeros(64)))])
def test_wrappers_reject_a_wrong_rank(fn, args):
    with pytest.raises(ValueError):
        getattr(fc, fn)(*args())
    with pytest.raises(NotImplementedError):
        getattr(fc, fn)(args()[0][None].to("meta"), *args()[1:])


# -- Decoder3D under the knob ----------------------------------------------------------

_DD = dict(z_channels=32, resolution=32, ch=64, ch_mult=(1, 2), depths=(2, 2), num_heads=(4, 4),
           window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))


def _count_calls(monkeypatch):
    """Count the calls Decoder3D makes to the two fused entry points."""
    calls = {"subpixel_up_conv3x3": 0, "fused_decoder_tail": 0}
    for name in calls:
        orig = getattr(tvae, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tvae, name, counted)
    return calls


def _jfuse(res, h, middle_only=False):
    if middle_only:       # mixes frames, returns the middle one
        return h[:, 1:2] + 0.1 * h.mean(axis=1, keepdims=True)
    return h


def _tfuse(res, h, middle_only=False):
    if middle_only:
        return h[:, 1:2] + 0.1 * h.mean(dim=1, keepdim=True)
    return h


@pytest.fixture(scope="module")
def decoder():
    z = _rand(np.random.default_rng(7), (6, 16, 16, 32), 0.5)
    jm = jvae.Decoder3D(jcfg.DDConfig(**_DD), dtype=jnp.bfloat16)
    v = random_variables(jm, jnp.asarray(z), seed=9)
    model = to_port(tvae.Decoder3D(tcfg.DDConfig(**_DD)), v)
    ref = _f32(japply(jm, v, z, fuse_fn=_jfuse, middle_only=True, fuse_resolutions=(16,)))
    return model, z, ref


@pytest.mark.parametrize("mode,want", [("1", {"subpixel_up_conv3x3": 0, "fused_decoder_tail": 1}),
                                       ("up", {"subpixel_up_conv3x3": 1, "fused_decoder_tail": 0})])
def test_decoder3d_fused_tail_matches_jax(monkeypatch, decoder, mode, want):
    model, z, ref = decoder
    m16 = tvae.Decoder3D(tcfg.DDConfig(**_DD), use_pallas=True)    # the knob needs the kernels' plan
    m16.load_state_dict(model.state_dict())
    m16 = m16.to(BF16).eval()
    run = lambda: m16(t(z).to(BF16), fuse_fn=_tfuse, middle_only=True, fuse_resolutions=(16,))
    with torch.no_grad():
        stock = run()
        calls = _count_calls(monkeypatch)
        knobs.set_knob("FUSED_TAIL", mode)
        out = run()
    assert calls == want
    assert out.shape == (2, 32, 32, 3) and out.dtype == BF16
    scale = np.abs(ref).max()
    for other in (ref, _np32(stock)):
        d = np.abs(_np32(out) - other)
        assert d.mean() <= 1e-2 * scale and d.max() <= 1e-1 * scale, (d.mean(), d.max(), scale)
    assert not torch.equal(out, stock)          # the knob did change the arithmetic


@pytest.mark.parametrize("case", ["fp32", "all_frames", "narrow", "grad_enabled"])
def test_decoder3d_guard_keeps_the_stock_path(monkeypatch, decoder, case):
    model, z, _ = decoder
    dd = dict(_DD)
    dtype, kw = BF16, dict(fuse_fn=_tfuse, middle_only=True, fuse_resolutions=(16,))
    if case == "fp32":
        dtype = torch.float32
    elif case == "all_frames":               # t_cur == 3 at the last upsample
        kw = {}
    elif case == "narrow":                   # C = 64 at level 1: C % 128 != 0
        dd.update(ch=32)
    m = tvae.Decoder3D(tcfg.DDConfig(**dd), use_pallas=True)
    if case != "narrow":
        m.load_state_dict(model.state_dict())
    else:
        tb.init_weights(m, torch.Generator().manual_seed(0))
    m = m.to(dtype).eval()
    x = t(z).to(dtype)
    with torch.set_grad_enabled(case == "grad_enabled"):
        stock = m(x, **kw)
        calls = _count_calls(monkeypatch)
        knobs.set_knob("FUSED_TAIL", "1")
        out = m(x, **kw)
        assert calls == {"subpixel_up_conv3x3": 0, "fused_decoder_tail": 0}
        assert torch.equal(out, stock)
        knobs.set_knob("FUSED_TAIL", "up")
        out = m(x, **kw)
    if case == "all_frames":                 # `up` has no one-frame condition
        assert calls == {"subpixel_up_conv3x3": 1, "fused_decoder_tail": 0}
        assert out.shape == stock.shape == (6, 32, 32, 3)
    else:
        assert calls == {"subpixel_up_conv3x3": 0, "fused_decoder_tail": 0}
        assert torch.equal(out, stock)
