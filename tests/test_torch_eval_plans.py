"""The evaluation plans SUBPIXEL, FUSE_TPATH and SW_RPS in the PyTorch port
against the JAX package's same plans (CPU), each plan set through both
packages' ``set_knob``.

* `Upsample` under ``dilated`` and ``quad`` and with ``subpixel=False``,
  `FuseSftBlock` under ``conv`` and ``einsum`` (with and without
  ``middle_only``): in fp32 within 1e-5 of max|ref| of JAX's same plan
  (summation order only).  In bf16 each is held closer to JAX's same plan
  than to a JAX plan that rounds elsewhere: no larger a maximum gap and a
  smaller share of differing outputs.  For the Fuse-SFT block the other
  plan is the other FUSE_TPATH, and its temporal path (tfusion1's input) is
  also compared alone.  The upsample's ``dilated`` and ``quad`` round at
  the same places (kernel taps equal bit for bit, the bias added after the
  conv in bf16): JAX's two give the same bf16 output but where fp32 sums in
  another order round the other way.  So each port plan is held to JAX's
  same plan within that noise (a thousandth of the outputs, half a bf16 ulp
  of the largest) and closer to it than to the ``subpixel=False`` plan.
  On a CPU tensor the module runs both through the phase convs
  (``nn/blocks.py:Upsample`` says why); the ``dilated`` plan's kernel and
  transposed conv (``subpixel_kernel``, ``subpixel_up_conv``) are called
  directly: the kernels JAX's convs receive, bit for bit, and the output.
* The upsample's gradient under ``dilated`` (the transposed conv, and the
  module's phase convs) against `jax.grad` of JAX's.
* `sw_plan`'s ``SW_RPS`` override and its refusals.
* The stage II-IV teacher runs the module path under ``use_pallas=True``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pgtformer_tpu.knobs as jknobs
import pgtformer_tpu.models.pgtformer as jpgt
import pgtformer_tpu.nn.blocks as jb
import pgtformer_tpu_torch.models.pgtformer as tpgt
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.ops.sw_block as sw
from pgtformer_tpu_torch import knobs
from tests.test_torch_common import (  # noqa: F401
    one_torch_thread, random_variables, small_configs, t, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = torch.bfloat16
FP32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    """No test leaks a knob of either package into another."""
    for name in knobs.KNOBS:
        monkeypatch.delenv("PGT_" + name, raising=False)
    knobs.reset()
    jknobs.reset()
    yield
    knobs.reset()
    jknobs.reset()


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values (held in fp32): both packages read the same
    bf16 input."""
    return _np32(jnp.asarray(x, jnp.bfloat16))


def _gap(a: np.ndarray, ref: np.ndarray):
    """(max|a - ref| / max|ref|, share of outputs that differ)."""
    d = np.abs(a - ref)
    return d.max() / np.abs(ref).max(), (d > 0).mean()


def _closer(name, got, same, other):
    """`got` no farther from `same` than from `other` in max gap, and
    strictly closer in share of differing outputs."""
    g_same, g_other = _gap(got, same), _gap(got, other)
    print(f"{name}: vs same plan max {g_same[0]:.3e} share {g_same[1]:.6f}; "
          f"vs other plan max {g_other[0]:.3e} share {g_other[1]:.6f}")
    assert g_same[0] <= g_other[0] and g_same[1] < g_other[1], (g_same, g_other)


def _summation_order_only(name, got, want):
    """At most a thousandth of the outputs differ, none by more than half a
    bf16 ulp of the largest output (an output that cancels can move by many
    of its own ulps when an fp32 sum rounds the other way)."""
    gap, share = _gap(got, want)
    print(f"{name}: {share:.6f} of outputs off, max|d| {gap:.3e} of max|ref|")
    assert gap <= 2.0 ** -8 and share <= 1e-3, (gap, share)


# -- SUBPIXEL ------------------------------------------------------------------------

UP_PLANS = {"dilated": ("dilated", True), "quad": ("quad", True), "plain": ("dilated", False)}
UP_OTHER = {"dilated": "plain", "quad": "plain", "plain": "dilated"}


def _up_case(C=64, seed=31):
    rng = np.random.default_rng(seed)
    k3 = (rng.normal(size=(3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32)     # HWIO
    b = (rng.normal(size=C) * 0.1).astype(np.float32)
    x = _bf16_exact(rng.normal(size=(2, 3, 6, 8, C)).astype(np.float32))
    return {"params": {"conv": {"kernel": k3, "bias": b}}}, x


def _port_up(v, subpixel: bool):
    C = v["params"]["conv"]["bias"].shape[0]
    up = tb.Upsample(C, subpixel=subpixel)
    up.load_state_dict({"conv.weight": t(v["params"]["conv"]["kernel"]).permute(3, 2, 0, 1),
                        "conv.bias": t(v["params"]["conv"]["bias"])})
    return up


def _jax_up(v, x, plan, dtype):
    knob, subpixel = UP_PLANS[plan]
    jknobs.set_knob("SUBPIXEL", knob)
    try:
        return _np32(jb.Upsample(subpixel=subpixel, dtype=dtype).apply(
            v, jnp.asarray(x, dtype)))
    finally:
        jknobs.reset()


@pytest.mark.parametrize("plan", list(UP_PLANS))
def test_upsample_fp32_matches_jax_plan(plan):
    v, x = _up_case()
    want = _jax_up(v, x, plan, jnp.float32)
    knob, subpixel = UP_PLANS[plan]
    knobs.set_knob("SUBPIXEL", knob)
    with torch.no_grad():
        got = _port_up(v, subpixel)(t(x))
    assert got.shape == (2, 3, 12, 16, 64) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= FP32_TOL * np.abs(want).max()


@pytest.mark.parametrize("plan", list(UP_PLANS))
def test_upsample_bf16_closer_to_jax_same_plan(plan):
    v, x = _up_case()
    same = _jax_up(v, x, plan, jnp.bfloat16)
    other = _jax_up(v, x, UP_OTHER[plan], jnp.bfloat16)
    knob, subpixel = UP_PLANS[plan]
    knobs.set_knob("SUBPIXEL", knob)
    up = _port_up(v, subpixel).to(BF16)
    assert all(p.dtype == torch.float32 for p in up.parameters())
    with torch.no_grad():
        got = up(t(x).to(BF16))
    assert got.dtype == BF16
    _closer(f"Upsample[{plan}] bf16", _np32(got), same, other)
    if plan != "plain":
        _summation_order_only(f"Upsample[{plan}] bf16 vs JAX's", _np32(got), same)
        twin = _jax_up(v, x, "quad" if plan == "dilated" else "dilated", jnp.bfloat16)
        _summation_order_only("JAX's dilated vs quad, bf16", twin, same)


def test_upsample_plans_cached_and_refreshed():
    """Without a gradient the plan's kernel is derived once; an in-place
    change of the parameter (an optimizer step) refreshes it."""
    v, x = _up_case(C=16)
    up = _port_up(v, True)
    with torch.no_grad():
        k = up._plan_weights("dilated", torch.float32)[0]
        assert up._plan_weights("dilated", torch.float32)[0] is k
        y0 = up(t(x))
        up.conv.weight.mul_(2.0)
        assert up._plan_weights("dilated", torch.float32)[0] is not k
        y1 = up(t(x))
    b = t(v["params"]["conv"]["bias"])
    torch.testing.assert_close(y1 - b, 2 * (y0 - b), rtol=1e-5, atol=1e-5)


def _capture_jax_kernels(monkeypatch, v, x, plan, dtype):
    """The kernels (rhs, HWIO) JAX's Upsample hands its convs under `plan`."""
    seen, conv = [], jax.lax.conv_general_dilated

    def spy(lhs, rhs, *args, **kwargs):
        seen.append(_np32(rhs))
        return conv(lhs, rhs, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "conv_general_dilated", spy)
        _jax_up(v, x, plan, dtype)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plan", ["dilated", "quad"])
def test_subpixel_kernel_is_jax_kernel(monkeypatch, plan, dtype):
    """The port's plan kernels, summed in fp32 and rounded once, are the
    ones JAX's convs receive bit for bit: K44 (undoing conv_transpose2d's
    layout) for ``dilated``, the four phase kernels for ``quad``."""
    v, x = _up_case(C=16)
    seen = _capture_jax_kernels(monkeypatch, v, x, plan, getattr(jnp, dtype))
    w = t(v["params"]["conv"]["kernel"]).permute(3, 2, 0, 1)
    k = tb.subpixel_kernel(w, plan).to(getattr(torch, dtype))
    if plan == "dilated":
        got = [k.transpose(0, 1).flip(2, 3).permute(2, 3, 1, 0)]       # [u, v, i, o]
    else:
        got = [k[a, b].permute(2, 3, 1, 0) for a in (0, 1) for b in (0, 1)]
    assert len(seen) == len(got)
    for g, want in zip(got, seen):
        assert g.shape == want.shape and np.array_equal(_np32(g), want)


def _port_plan(v, x, plan, dtype=torch.float32):
    """:func:`subpixel_up_conv` called directly (the module runs the phase
    convs on the CPU under either knob)."""
    w = t(v["params"]["conv"]["kernel"]).permute(3, 2, 0, 1)
    k = tb.subpixel_kernel(w, plan).to(dtype)
    b = t(v["params"]["conv"]["bias"]).to(dtype)
    xs = t(x).to(dtype)
    y = tb.subpixel_up_conv(xs.reshape(-1, *xs.shape[2:]), k, b, plan)
    return y.reshape(*xs.shape[:2], *y.shape[1:])


@pytest.mark.parametrize("plan", ["dilated", "quad"])
def test_subpixel_up_conv_fp32_matches_jax_plan(plan):
    v, x = _up_case()
    want = _jax_up(v, x, plan, jnp.float32)
    with torch.no_grad():
        got = _port_plan(v, x, plan)
    assert got.shape == want.shape == (2, 3, 12, 16, 64)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL * np.abs(want).max()


@pytest.mark.parametrize("plan", ["dilated", "quad"])
def test_subpixel_up_conv_bf16_is_jax_plan(plan):
    v, x = _up_case()
    same = _jax_up(v, x, plan, jnp.bfloat16)
    with torch.no_grad():
        got = _np32(_port_plan(v, x, plan, BF16))
    _closer(f"subpixel_up_conv[{plan}] bf16", got, same, _jax_up(v, x, "plain", jnp.bfloat16))
    _summation_order_only(f"subpixel_up_conv[{plan}] bf16 vs JAX's", got, same)


def test_upsample_module_runs_the_phase_convs_on_the_cpu():
    """On a CPU tensor the module runs ``quad`` under either knob value."""
    v, x = _up_case(C=16)
    knobs.set_knob("SUBPIXEL", "dilated")
    with torch.no_grad():
        assert torch.equal(_port_up(v, True)(t(x)), _port_plan(v, x, "quad"))


def _jax_up_grads(v, x, cot):
    jknobs.set_knob("SUBPIXEL", "dilated")
    jmod = jb.Upsample()
    loss = lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx) * cot)
    jg, jgx = jax.grad(loss, argnums=(0, 1))(v["params"], jnp.asarray(x))
    return np.asarray(jg["conv"]["kernel"]).transpose(3, 2, 0, 1), jg["conv"]["bias"], jgx


def _assert_grads(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= FP32_TOL * np.abs(w).max()


def test_upsample_dilated_gradient_matches_jax():
    """d/d(k3, bias, x) of a fixed cotangent through the ``dilated`` plan
    (:func:`subpixel_kernel` of the live parameter, then the transposed
    conv), against jax.grad of JAX's (fp32, 1e-5 of each gradient's max)."""
    v, x = _up_case(C=16, seed=32)
    cot = np.random.default_rng(33).normal(size=(2, 3, 12, 16, 16)).astype(np.float32)
    want = _jax_up_grads(v, x, cot)
    w = t(v["params"]["conv"]["kernel"]).permute(3, 2, 0, 1).requires_grad_(True)
    b = t(v["params"]["conv"]["bias"]).requires_grad_(True)
    xt = t(x).requires_grad_(True)
    y = tb.subpixel_up_conv(xt.reshape(6, 6, 8, 16), tb.subpixel_kernel(w, "dilated"), b,
                            "dilated")
    (y.reshape(cot.shape) * t(cot)).sum().backward()
    _assert_grads((w.grad, b.grad, xt.grad), want)


def test_upsample_module_gradient_matches_jax():
    """The module's gradient (the phase convs of the live parameter on the
    CPU) against jax.grad of JAX's ``dilated`` plan."""
    v, x = _up_case(C=16, seed=32)
    cot = np.random.default_rng(33).normal(size=(2, 3, 12, 16, 16)).astype(np.float32)
    want = _jax_up_grads(v, x, cot)
    up = _port_up(v, True)
    xt = t(x).requires_grad_(True)
    (up(xt) * t(cot)).sum().backward()
    _assert_grads((up.conv.weight.grad, up.conv.bias.grad, xt.grad), want)


# -- FUSE_TPATH ----------------------------------------------------------------------

FUSE_OTHER = {"conv": "einsum", "einsum": "conv"}


@pytest.fixture(scope="module")
def fuse_case():
    rng = np.random.default_rng(41)
    C = 64
    enc, dec = (_bf16_exact(rng.normal(size=(2, 3, 8, 8, C)).astype(np.float32))
                for _ in range(2))
    jmod = jpgt.FuseSftBlock(C, C, t=3)
    v = random_variables(jmod, jnp.asarray(enc), jnp.asarray(dec), seed=42)
    return v, enc, dec


def _jax_fuse(v, enc, dec, plan, dtype, middle_only):
    jknobs.set_knob("FUSE_TPATH", plan)
    try:
        jmod = jpgt.FuseSftBlock(64, 64, t=3, dtype=dtype)
        return _np32(jmod.apply(v, jnp.asarray(enc, dtype), jnp.asarray(dec, dtype), w=0.7,
                                middle_only=middle_only))
    finally:
        jknobs.reset()


@pytest.mark.parametrize("middle_only", [False, True])
@pytest.mark.parametrize("plan", ["conv", "einsum"])
def test_fuse_sft_fp32_matches_jax_plan(fuse_case, plan, middle_only):
    v, enc, dec = fuse_case
    want = _jax_fuse(v, enc, dec, plan, jnp.float32, middle_only)
    knobs.set_knob("FUSE_TPATH", plan)
    with torch.no_grad():
        got = to_port(tpgt.FuseSftBlock(64, 64, t=3), v)(t(enc), t(dec), w=0.7,
                                                          middle_only=middle_only)
    assert got.shape == (2, 1 if middle_only else 3, 8, 8, 64)
    assert np.abs(got.numpy() - want).max() <= FP32_TOL * np.abs(want).max()


@pytest.mark.parametrize("middle_only", [False, True])
@pytest.mark.parametrize("plan", ["conv", "einsum"])
def test_fuse_sft_bf16_closer_to_jax_same_plan(fuse_case, plan, middle_only):
    v, enc, dec = fuse_case
    same = _jax_fuse(v, enc, dec, plan, jnp.bfloat16, middle_only)
    other = _jax_fuse(v, enc, dec, FUSE_OTHER[plan], jnp.bfloat16, middle_only)
    knobs.set_knob("FUSE_TPATH", plan)
    mod = to_port(tpgt.FuseSftBlock(64, 64, t=3), v).to(BF16)
    for name in ("tconvenc", "tconvdec", "tfusion0"):
        assert all(p.dtype == torch.float32 for p in getattr(mod, name).parameters()), name
    with torch.no_grad():
        got = mod(t(enc).to(BF16), t(dec).to(BF16), w=0.7, middle_only=middle_only)
    assert got.dtype == BF16
    _closer(f"FuseSftBlock[{plan}, middle_only={middle_only}] bf16", _np32(got), same, other)


def _jax_tpath(v, enc, dec, plan, middle_only):
    """JAX's bf16 temporal path: the input of its `tfusion1` conv."""
    seen = []

    def grab(next_fn, args, kwargs, context):
        if context.module.name == "tfusion1" and context.method_name == "__call__":
            seen.append(_np32(args[0]))
        return next_fn(*args, **kwargs)

    with fnn.intercept_methods(grab):
        _jax_fuse(v, enc, dec, plan, jnp.bfloat16, middle_only)
    return seen[0]


@pytest.mark.parametrize("middle_only", [False, True])
@pytest.mark.parametrize("plan", ["conv", "einsum"])
def test_fuse_sft_bf16_temporal_path_is_jax_same_plan(fuse_case, plan, middle_only):
    """The temporal path alone, where the plans differ: the port's bf16
    output within summation-order noise of JAX's same plan (bit-equal at
    this size for ``conv``), far from the other plan's."""
    v, enc, dec = fuse_case
    same = _jax_tpath(v, enc, dec, plan, middle_only)
    other = _jax_tpath(v, enc, dec, FUSE_OTHER[plan], middle_only)
    knobs.set_knob("FUSE_TPATH", plan)
    mod = to_port(tpgt.FuseSftBlock(64, 64, t=3), v).to(BF16)
    seen = []
    mod.tfusion1.register_forward_pre_hook(lambda m, a: seen.append(a[0].permute(0, 2, 3, 1)))
    with torch.no_grad():
        mod(t(enc).to(BF16), t(dec).to(BF16), w=0.7, middle_only=middle_only)
    got = _np32(seen[0])
    assert got.shape == same.shape == (2 * (1 if middle_only else 3), 8, 8, 32)
    _closer(f"temporal path [{plan}, middle_only={middle_only}] bf16", got, same, other)
    _summation_order_only(f"temporal path [{plan}, middle_only={middle_only}]", got, same)


def test_fuse_sft_gradient_reaches_the_folded_parameters(fuse_case):
    """Under a recorded gradient the ``conv`` plan folds the live
    parameters: the 1x1 convs and tfusion0 get the gradient the ``einsum``
    plan gives them (fp32, the same function)."""
    v, enc, dec = fuse_case
    grads = {}
    for plan in ("conv", "einsum"):
        knobs.set_knob("FUSE_TPATH", plan)
        mod = to_port(tpgt.FuseSftBlock(64, 64, t=3), v)
        mod(t(enc), t(dec), w=0.7).square().sum().backward()
        grads[plan] = {n: p.grad.clone() for n, p in mod.named_parameters()
                       if n.split(".")[0] in ("tconvenc", "tconvdec", "tfusion0")}
    assert len(grads["conv"]) == 6
    for n, g in grads["conv"].items():
        ref = grads["einsum"][n]
        assert (g - ref).abs().max() <= 1e-4 * ref.abs().max(), n


def test_fuse_sft_folded_weights_cached_on_the_three_convs(fuse_case):
    """Without a gradient the folded weights are built once and rebuilt
    when a parameter of tconvenc, tconvdec or tfusion0 changes in place,
    not when another parameter of the block does."""
    v, enc, dec = fuse_case
    mod = to_port(tpgt.FuseSftBlock(64, 64, t=3), v)
    with torch.no_grad():
        w = mod._tpath_weights("conv", 3, False, torch.float32)
        mod.encode_enc.conv1.weight.mul_(2.0)
        mod.scale[0].bias.add_(1.0)
        assert mod._tpath_weights("conv", 3, False, torch.float32) is w
        for conv in (mod.tconvenc, mod.tconvdec, mod.tfusion0):
            conv.bias.add_(0.5)
            assert mod._tpath_weights("conv", 3, False, torch.float32) is not w
            w = mod._tpath_weights("conv", 3, False, torch.float32)


# -- SW_RPS ----------------------------------------------------------------------------

@pytest.mark.parametrize("rps,C,pair,nw", [("", 256, False, 2), ("", 512, False, 1),
                                           ("", 256, True, 1), ("1", 256, False, 1),
                                           ("2", 256, False, 2), ("1", 512, False, 1),
                                           ("1", 256, True, 1)])
def test_sw_rps_sets_slabs_per_cta(rps, C, pair, nw):
    knobs.set_knob("SW_RPS", rps)
    p = sw.sw_plan(C, 8, 48, 100, pair=pair)
    assert p.nw == nw and p.grid == -(-p.nslab // nw)
    assert p.smem <= sw.SMEM_LIMIT


@pytest.mark.parametrize("rps,C,pair,fit", [("0", 256, False, "1, 2"), ("3", 256, False, "1, 2"),
                                            ("2", 512, False, "1"), ("2", 256, True, "1"),
                                            ("two", 256, False, "1, 2")])
def test_sw_rps_refuses_what_does_not_fit(rps, C, pair, fit):
    knobs.set_knob("SW_RPS", rps)
    with pytest.raises(ValueError, match=f"slabs per CTA that fit: {fit}$"):
        sw.sw_plan(C, 8, 48, 100, pair=pair)


def test_sw_rps_ignored_by_the_plain_versions():
    """On a CPU tensor the wrappers run their plain versions, which have no
    plan: any value, even one no kernel takes, gives the default output."""
    C = 64
    blk = tb.SWTransformerBlock(C, 4, 3, (4, 4), (2, 2), mlp_ratio=1.0)
    tb.init_weights(blk, torch.Generator().manual_seed(5))
    w = blk.kernel_weights(torch.device("cpu"))
    x = torch.randn(1, 3, 8, 8, C, generator=torch.Generator().manual_seed(6))
    ref = sw.sw_block(x, w, (2, 2))
    knobs.set_knob("SW_RPS", "3")
    assert torch.equal(sw.sw_block(x, w, (2, 2)), ref)


# -- the stage II-IV teacher -----------------------------------------------------------

def test_teacher_runs_the_module_path_under_pallas():
    from pgtformer_tpu_torch import bench_train_step
    from pgtformer_tpu_torch.train.stages import PGTFormerTrainer
    _, tc = small_configs()
    tr = PGTFormerTrainer(tc, "III", device="cpu", use_pallas=True)
    flags = lambda m: {x.use_pallas for x in m.modules() if hasattr(x, "use_pallas")}
    assert flags(tr.model) == {True} and flags(tr.teacher) == {False}
    bench_train_step.set_plan(tr, False, torch.float32)
    bench_train_step.set_plan(tr, True, BF16)
    assert flags(tr.model) == {True} and flags(tr.teacher) == {False}
