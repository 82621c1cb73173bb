"""Gradients through the kernels' autograd Functions (K1/K3/K4, K2/K6) on
the CPU, where the plain version stands in for each kernel.

* Each wrapper, given inputs that require a gradient, runs its Function;
  its output is its plain version's (in fp32 the kernels' fp32 form), and
  its gradients are autograd's through the XLA form it recomputes (as the
  JAX package's custom VJPs differentiate its XLA path): x, every weight,
  the gathered bias (K1/K3/K4), q, k, v (K2/K6), equal to within 1e-6
  relative (the recompute may fuse nothing else).
* An `EncoderLayer(use_pallas=True)` (both shifts; each of the three plans)
  and a `TransformerSALayer` against the JAX package's gradients: gradients
  of x and of every parameter within 1e-4 of that tensor's largest
  magnitude, or of 1e-2 of the largest parameter gradient's where that is
  larger (fp32 sums in another order; the relative-position table's
  gradient is a scatter-add of the gathered bias's).  For the layer, the
  custom VJP's gradients: JAX's XLA blocks differentiated at the inputs
  each kernel call saved (the port's forward values; in fp32 block 1's
  input is block 0's fp32-form output), chained as the calls were; the
  pair is one call, so its gradient is `jax.grad` of the XLA layer.
* After an optimizer step the next forward, with or without a recorded
  gradient, uses the new weights: the kernel-weight cache follows the
  parameters' versions.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import pgtformer_tpu.nn.blocks as jb
import pgtformer_tpu.nn.transformer as jt
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.nn.transformer as tt
from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.convert import flax_to_state_dict
from pgtformer_tpu_torch.ops import dense_mha as dm
from pgtformer_tpu_torch.ops import sw_block as sw
from pgtformer_tpu_torch.ops.window import shifted_window_mask, window_partition
from tests.test_torch_common import (  # noqa: F401
    leaf_scales, one_torch_thread, random_variables, t, to_port)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in knobs.KNOBS:
        monkeypatch.delenv("PGT_" + name, raising=False)
    knobs.reset()
    yield
    knobs.reset()


def _layer(C=64, hw=(8, 12), depth=2, seed=0):
    x = RNG.normal(size=(2, 3, *hw, C)).astype(np.float32)
    jmod = jb.EncoderLayer(dim=C, depth=depth, num_heads=4, num_frames=3,
                           window_size=(4, 4), mlp_ratio=1.0)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    mod = to_port(tb.EncoderLayer(C, depth, 4, 3, (4, 4), mlp_ratio=1.0, use_pallas=True), v)
    return jmod, v, mod, x


def _leaves(w: sw.SWBlockWeights):
    """The block's weights as fresh leaves that require a gradient."""
    ts = [a.detach().clone().requires_grad_() for a in w[:17]]
    return sw.SWBlockWeights(*ts, w.num_heads, w.window), ts


fn_names = []      # type of the last `_grads` call's grad_fn


def _grads(fn, inputs, cot):
    out = fn()
    fn_names[:] = [type(out.grad_fn).__name__]
    return [g.detach().clone() for g in torch.autograd.grad(out, inputs, cot)], out.detach()


def _assert_same(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6 * max(y.abs().max().item(), 1e-30))


@pytest.mark.parametrize("kind", ["block", "tokens", "pair"])
@pytest.mark.parametrize("shift", [(0, 0), (2, 2)])
def test_sw_block_functions_match_plain_autograd(kind, shift):
    _, _, mod, x = _layer()
    w0, w1 = (b.kernel_weights(torch.device("cpu")) for b in mod.blocks)
    cot = torch.from_numpy(RNG.normal(size=x.shape).astype(np.float32))
    xt = t(x)
    if kind == "tokens":
        xt = window_partition(torch.roll(xt, (-2, -2), dims=(2, 3)), (4, 4)).contiguous()
        cot = torch.from_numpy(RNG.normal(size=xt.shape).astype(np.float32))
        mask = shifted_window_mask(3, 8, 12, (4, 4), (2, 2)) if any(shift) else None
        runs = [lambda xx, w, _: sw.sw_block_tokens(xx, w, mask, 6),
                lambda xx, w, _: sw.sw_block_tokens_xla(xx, w, mask, 6)]
        plain = lambda xx, w, _: sw.sw_block_tokens_plain(xx, w, mask, 6)
    elif kind == "block":
        runs = [lambda xx, w, _: sw.sw_block(xx, w, shift),
                lambda xx, w, _: sw.sw_block_xla(xx, w, shift)]
        plain = lambda xx, w, _: sw.sw_block_plain(xx, w, shift)
    else:
        runs = [lambda xx, w, wb: sw.sw_block_pair(xx, w, wb, shift),
                lambda xx, w, wb: sw.sw_block_pair_xla(xx, w, wb, shift)]
        plain = lambda xx, w, wb: sw.sw_block_pair_plain(xx, w, wb, shift)
    results, names = [], []
    for fn in runs:
        xx = xt.detach().clone().requires_grad_()
        w, ts = _leaves(w0)
        wb, tsb = _leaves(w1)
        inputs = [xx, *ts, *(tsb if kind == "pair" else [])]
        results.append(_grads(lambda: fn(xx, w, wb), inputs, cot))
        names += fn_names
    (g_fn, out_fn), (g_xla, _) = results
    assert names[0] == "KernelFunctionBackward" != names[1]    # the wrapper took the Function
    with torch.no_grad():
        assert torch.equal(out_fn, plain(xt, w0, w1))
    assert len(g_fn) == 1 + 17 * (2 if kind == "pair" else 1)
    _assert_same(g_fn, g_xla)
    assert all(g.abs().max() > 0 for g in g_fn)


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_dense_mha_function_matches_plain_autograd(layout):
    q, k, v = (torch.from_numpy(RNG.normal(size=(2, 40, 4, 16)).astype(np.float32))
               for _ in range(3))
    if layout == "bhnd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    plain = dm.dense_mha_plain if layout == "bhnd" else dm.dense_mha_plain_bnhd
    ref = dm.dense_mha_ref if layout == "bhnd" else dm.dense_mha_ref_bnhd
    cot = torch.from_numpy(RNG.normal(size=q.shape).astype(np.float32))
    res, names = [], []
    for fn in (lambda a, b, c: dm.dense_mha(a, b, c, scale=0.25, layout=layout),
               lambda a, b, c: ref(a, b, c, 0.25)):
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        res.append(_grads(lambda: fn(*leaves), leaves, cot))
        names += fn_names
    assert names[0] == "KernelFunctionBackward" != names[1]
    assert torch.equal(res[0][1], plain(q, k, v, 0.25))
    _assert_same(res[0][0], res[1][0])
    with pytest.raises(ValueError, match="layout"):
        dm.dense_mha(q, k, v, scale=0.25, layout="nope")
    with torch.no_grad():                     # no gradient recorded: no Function
        assert dm.dense_mha(*leaves, scale=0.25, layout=layout).grad_fn is None


def _jax_grads(jmod, v, x, cot, *extra):
    def f(params, xx):
        return jnp.sum(jmod.apply({**v, "params": params}, xx, *extra) * cot)
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    return flax_to_state_dict({"params": gp}), np.asarray(gx)


def _chain_grads(jmod, v, x, y0, cot):
    """The custom VJP of two single-block kernel calls: JAX's XLA block 1
    differentiated at y0 (what the second call saved), its input cotangent
    through JAX's XLA block 0 at x."""
    half = tuple(w // 2 for w in jmod.window_size)
    blocks = [jb.SWTransformerBlock(dim=jmod.dim, num_heads=jmod.num_heads,
                                    num_frames=jmod.num_frames, window_size=jmod.window_size,
                                    shift_size=s, mlp_ratio=jmod.mlp_ratio)
              for s in ((0, 0), half)]
    p = v["params"]

    def vjp(i, xx, g):
        _, back = jax.vjp(lambda pp, z: blocks[i].apply({"params": pp}, z),
                          p[f"blocks_{i}"], jnp.asarray(xx))
        return back(g)

    g1, gy = vjp(1, y0, cot)
    g0, gx = vjp(0, x, gy)
    return flax_to_state_dict({"params": {"blocks_0": g0, "blocks_1": g1}}), np.asarray(gx)


def _assert_grads(mod, xt, gp, gx, rel=1e-4):
    scale = leaf_scales(gp, list(gp))
    for n, p in mod.named_parameters():
        assert p.grad is not None, n
        err = np.abs(p.grad.numpy() - gp[n]).max()
        assert err <= rel * scale[n], (n, err, scale[n])
    np.testing.assert_allclose(xt.grad.numpy(), gx, rtol=0, atol=rel * np.abs(gx).max())


@pytest.mark.parametrize("plan", ["5d", "tokens", "pair"])
def test_encoder_layer_gradients_match_jax(monkeypatch, plan):
    """Every parameter of both blocks (q, kv, proj, fc1/2, norms, the bias
    table) gets the JAX package's gradient, under each plan's Function."""
    jmod, v, mod, x = _layer(seed=2)
    calls = {}
    for name in ("sw_block", "sw_block_tokens", "sw_block_pair"):
        orig = getattr(tb, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            out = _orig(*a, **kw)
            key = (_name, type(out.grad_fn).__name__)
            calls[key] = calls.get(key, 0) + 1
            return out
        monkeypatch.setattr(tb, name, counted)
    if plan == "tokens":
        knobs.set_knob("SW_KERNEL", "tokens")
    elif plan == "pair":
        knobs.set_knob("SW_PAIR", "1")
    cot = RNG.normal(size=x.shape).astype(np.float32)
    if plan == "pair":
        gp, gx = _jax_grads(jmod, v, x, jnp.asarray(cot))
    else:
        with torch.no_grad():
            y0 = sw.sw_block_plain(t(x), mod.blocks[0].kernel_weights(torch.device("cpu")), (0, 0))
        gp, gx = _chain_grads(jmod, v, x, y0.numpy(), jnp.asarray(cot))
    xt = t(x).requires_grad_()
    (mod(xt) * torch.from_numpy(cot)).sum().backward()
    entry = {"5d": "sw_block", "tokens": "sw_block_tokens", "pair": "sw_block_pair"}[plan]
    assert calls == {(entry, "KernelFunctionBackward"): 1 if plan == "pair" else 2}
    _assert_grads(mod, xt, gp, gx)


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_transformer_sa_layer_gradients_match_jax(layout):
    x = RNG.normal(size=(2, 48, 64)).astype(np.float32)
    pos = RNG.normal(size=(2, 48, 64)).astype(np.float32)
    jmod = jt.TransformerSALayer(embed_dim=64, nhead=4, dim_mlp=128)
    v = random_variables(jmod, jnp.asarray(x), jnp.asarray(pos), seed=3)
    mod = to_port(tt.TransformerSALayer(64, 4, 128, mha_layout=layout), v)
    cot = RNG.normal(size=x.shape).astype(np.float32)
    gp, gx = _jax_grads(jmod, v, x, jnp.asarray(cot), jnp.asarray(pos))
    xt = t(x).requires_grad_()
    (mod(xt, query_pos=t(pos)) * torch.from_numpy(cot)).sum().backward()
    _assert_grads(mod, xt, gp, gx)


def test_next_forward_uses_the_stepped_weights():
    """An SGD step moves every parameter; the next forward, with and without
    a recorded gradient, equals a fresh layer built from the new weights,
    and the kernel-layout copy (bf16, made for a card) is remade."""
    _, _, mod, x = _layer(seed=4)
    blk = mod.blocks[1]
    cuda = torch.device("cuda")
    before = blk.kernel_weights(cuda)                   # cached bf16 copies
    assert blk.kernel_weights(cuda) is before
    opt = torch.optim.SGD(mod.parameters(), lr=0.1)
    mod(t(x)).square().mean().backward()
    opt.step()
    after = blk.kernel_weights(cuda)
    assert after is not before
    assert torch.equal(after.wq, blk.attn.q.weight.detach().to(torch.bfloat16))
    assert not torch.equal(after.wq, before.wq)
    assert torch.equal(after.rel_bias, blk.attn.rel_bias().detach())
    fresh = tb.EncoderLayer(64, 2, 4, 3, (4, 4), mlp_ratio=1.0, use_pallas=True)
    fresh.load_state_dict(mod.state_dict())
    with torch.no_grad():
        ref = fresh(t(x))
        assert torch.equal(mod(t(x)), ref)
    assert torch.equal(mod(t(x)).detach(), ref)
