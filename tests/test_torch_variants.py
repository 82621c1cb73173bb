"""The serving step's other evaluation plans in the PyTorch port, and the
knob registry that selects them (CPU).

* EncoderLayer under SW_KERNEL=tokens and SW_PAIR=1 against the default
  plan (exactly equal on the CPU, where every plan runs plain PyTorch on the
  same operands in the same order) and the JAX XLA path (1e-5 abs + 1e-5
  relative, fp32 summation order);
* dense_mha's two layouts against the JAX package's dense_mha (Pallas,
  interpret mode): 2e-2 * max|ref| in bf16 (the plain version rounds the
  probabilities after normalization, the Pallas kernel before), 1e-5 in fp32
  against its XLA reference;
* knobs: validation, environment fallback, CLI flags, registry subset.
"""

import argparse

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import pgtformer_tpu.knobs as jknobs
import pgtformer_tpu.nn.blocks as jb
import pgtformer_tpu.nn.transformer as jt
import pgtformer_tpu.ops.flash_attn as jfa
import pgtformer_tpu_torch.nn.blocks as tb
import pgtformer_tpu_torch.nn.transformer as tt
import pgtformer_tpu_torch.ops.sw_block as sw
from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops.dense_mha import (
    dense_mha, dense_mha_bhnd, dense_mha_bnhd, dense_mha_plain, dense_mha_plain_bnhd)
from pgtformer_tpu_torch.ops.window import shifted_window_mask, window_partition
from tests.test_torch_common import close, japply, random_variables, t, to_port

RNG = np.random.default_rng(21)


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    """No test leaks a knob (override or environment) into another."""
    for name in knobs.KNOBS:
        monkeypatch.delenv("PGT_" + name, raising=False)
    knobs.reset()
    yield
    knobs.reset()


def _layer(C, hw, depth=2, seed=0):
    x = RNG.normal(size=(2, 3, *hw, C)).astype(np.float32)
    jmod = jb.EncoderLayer(dim=C, depth=depth, num_heads=4, num_frames=3,
                           window_size=(4, 4), mlp_ratio=1.0)
    v = random_variables(jmod, jnp.asarray(x), seed=seed)
    return jmod, v, to_port(tb.EncoderLayer(C, depth, 4, 3, (4, 4), mlp_ratio=1.0), v), x


def _count_calls(monkeypatch):
    """Count the calls EncoderLayer makes to each sw_block wrapper."""
    calls = {"sw_block": 0, "sw_block_tokens": 0, "sw_block_pair": 0}
    for name in calls:
        orig = getattr(tb, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(tb, name, counted)
    return calls


PLANS = {"tokens": ("SW_KERNEL", "tokens"), "pair": ("SW_PAIR", "1")}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("C,hw,depth", [(64, (8, 8), 2), (128, (8, 12), 2), (64, (8, 8), 3)])
def test_encoder_layer_plan_equals_default(monkeypatch, plan, C, hw, depth):
    jmod, v, mod, x = _layer(C, hw, depth)
    with torch.no_grad():
        default = mod(t(x))
    calls = _count_calls(monkeypatch)
    knobs.set_knob(*PLANS[plan])
    with torch.no_grad():
        out = mod(t(x))
    assert torch.equal(out, default)
    close(out, japply(jmod, v, x), atol=1e-5, rtol=1e-5)
    if plan == "tokens":
        assert calls == {"sw_block": 0, "sw_block_tokens": depth, "sw_block_pair": 0}
    else:   # pairs, then the leftover block on its own
        assert calls == {"sw_block": depth % 2, "sw_block_tokens": 0,
                         "sw_block_pair": depth // 2}


def test_default_plan_is_one_5d_block_per_launch(monkeypatch):
    _, _, mod, x = _layer(64, (8, 8))
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        mod(t(x))
    assert calls == {"sw_block": 2, "sw_block_tokens": 0, "sw_block_pair": 0}
    knobs.set_knob("SW_KERNEL", "tokens")
    knobs.set_knob("SW_PAIR", "1")          # the pair plan applies to 5d only
    with torch.no_grad():
        mod(t(x))
    assert calls == {"sw_block": 2, "sw_block_tokens": 2, "sw_block_pair": 0}


@pytest.mark.parametrize("hw,pairs,singles", [((4, 4), 0, 2), ((4, 8), 1, 0)])
def test_pair_plan_with_clamped_shift(monkeypatch, hw, pairs, singles):
    """Where H and W equal the window the shift is clamped to 0: the layer
    is no [no-shift, shift] pair and runs two single blocks.  Where only H
    does, the shift survives along W and the pair runs."""
    jmod, v, mod, x = _layer(64, hw)
    with torch.no_grad():
        default = mod(t(x))
    calls = _count_calls(monkeypatch)
    knobs.set_knob("SW_PAIR", "1")
    with torch.no_grad():
        out = mod(t(x))
    assert calls == {"sw_block": singles, "sw_block_tokens": 0, "sw_block_pair": pairs}
    assert torch.equal(out, default)
    close(out, japply(jmod, v, x), atol=1e-5, rtol=1e-5)


def test_pair_and_token_plain_versions():
    """The pair's plain version is two single plain calls, exactly; the
    token plain version on rolled, partitioned tokens with the mask is the
    5-D plain version's core."""
    _, _, mod, x = _layer(64, (8, 12), seed=3)
    w0, w1 = (b.kernel_weights(torch.device("cpu")) for b in mod.blocks)
    with torch.no_grad():
        two = sw.sw_block_plain(sw.sw_block_plain(t(x), w0, (0, 0)), w1, (2, 2))
        assert torch.equal(sw.sw_block_pair_plain(t(x), w0, w1, (2, 2)), two)
        assert torch.equal(sw.sw_block_pair(t(x), w0, w1, (2, 2)), two)
        rolled = torch.roll(t(x), (-2, -2), dims=(2, 3))
        tok = window_partition(rolled, (4, 4))
        mask = shifted_window_mask(3, 8, 12, (4, 4), (2, 2))
        a = sw.sw_block_tokens(tok, w1, mask, 6)
        b = sw.sw_block_tokens_plain(tok, w1, torch.from_numpy(mask), 6)
        assert torch.equal(a, b)
        assert not torch.equal(a, sw.sw_block_tokens(tok, w1, None, 6))


@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_mha_layouts_match_jax(layout, dtype):
    B, H, N, D = 2, 4, 40, 16
    shape = (B, H, N, D) if layout == "bhnd" else (B, N, H, D)
    q, k, v = (RNG.normal(size=shape).astype(np.float32) for _ in range(3))
    tq, tk, tv = (t(a).to(getattr(torch, dtype)) for a in (q, k, v))
    out = dense_mha(tq, tk, tv, scale=0.25, layout=layout)
    assert out.shape == shape and out.dtype == tq.dtype
    plain = {"bhnd": dense_mha_plain, "bnhd": dense_mha_plain_bnhd}[layout]
    assert torch.equal(out, plain(tq, tk, tv, 0.25))
    entry = {"bhnd": dense_mha_bhnd, "bnhd": dense_mha_bnhd}[layout]
    assert torch.equal(out, entry(tq, tk, tv, 0.25))
    if dtype == "bfloat16":
        jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
        ref = np.asarray(jfa.dense_mha(jq, jk, jv, scale=0.25, layout=layout,
                                       interpret=True).astype(jnp.float32))
        err = np.abs(out.float().numpy() - ref).max()
        assert err <= 2e-2 * np.abs(ref).max(), err
    else:
        tr = (lambda a: a.transpose(0, 2, 1, 3)) if layout == "bnhd" else (lambda a: a)
        ref = tr(np.asarray(jfa._dense_mha_ref(*(jnp.asarray(tr(a)) for a in (q, k, v)), 0.25)))
        close(out, ref, atol=1e-5, rtol=0)


def test_dense_mha_rejects_unknown_layout():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        dense_mha(q, q, q, scale=0.25, layout="nbhd")
    with pytest.raises(ValueError):
        dense_mha(q[0], q[0], q[0], scale=0.25)
    with pytest.raises(ValueError):
        tt.MultiHeadSelfAttention(64, 4, mha_layout="nbhd")


@pytest.mark.parametrize("same_qk", [True, False])
def test_mhsa_layouts_agree(same_qk):
    """mha_layout="bhnd" equals "bnhd" exactly on the CPU, and the JAX module."""
    q, k, vv = (RNG.normal(size=(2, 16, 64)).astype(np.float32) for _ in range(3))
    jmod = jt.MultiHeadSelfAttention(embed_dim=64, num_heads=4)
    v = random_variables(jmod, jnp.asarray(q), jnp.asarray(k), jnp.asarray(vv), seed=1)
    a = to_port(tt.MultiHeadSelfAttention(64, 4), v)
    b = to_port(tt.MultiHeadSelfAttention(64, 4, mha_layout="bhnd"), v)
    assert a.mha_layout == "bnhd" and b.mha_layout == "bhnd"
    tq = t(q)
    tk = tq if same_qk else t(k)
    with torch.no_grad():
        out_a, out_b = a(tq, tk, t(vv)), b(tq, tk, t(vv))
    assert torch.equal(out_a, out_b)
    if not same_qk:
        close(out_a, japply(jmod, v, q, k, vv))
    layer = tt.TransformerSALayer(64, 4, 128, mha_layout="bhnd")
    assert layer.self_attn.mha_layout == "bhnd"


# -- knobs ---------------------------------------------------------------------

def test_knob_registry_is_a_subset_of_the_jax_packages():
    assert set(knobs.KNOBS) == {"EXACT_VQ", "SW_KERNEL", "SW_PAIR", "FUSED_TAIL"}
    for name, knob in knobs.KNOBS.items():
        ref = jknobs.KNOBS[name]
        assert (knob.default, knob.choices) == (ref.default, ref.choices), name
        assert knobs.get(name) == ref.default
        for word in ("TPU", "Pallas", "VMEM", "%", "ms"):   # no TPU finding is copied
            assert word not in knob.help.split(), (name, word)


@pytest.mark.parametrize("name,value", [("SW_KERNEL", "tokens"), ("SW_PAIR", "1"),
                                        ("EXACT_VQ", "1"), ("FUSED_TAIL", "up"),
                                        ("FUSED_TAIL", "1")])
def test_knob_resolution_order(monkeypatch, name, value):
    default = knobs.KNOBS[name].default
    assert knobs.get(name) == default
    monkeypatch.setenv("PGT_" + name, value)
    assert knobs.get(name) == value             # environment beats the default
    knobs.set_knob(name, default)
    assert knobs.get(name) == default           # set_knob beats the environment
    knobs.reset(name)
    assert knobs.get(name) == value
    monkeypatch.setenv("PGT_" + name, "bogus")
    with pytest.raises(ValueError):
        knobs.get(name)
    with pytest.raises(ValueError):
        knobs.set_knob(name, "bogus")
    with pytest.raises(KeyError):
        knobs.get("SW_RPS")


def test_knob_cli_flags():
    parser = argparse.ArgumentParser()
    knobs.add_cli_flags(parser)
    jparser = argparse.ArgumentParser()
    jknobs.add_cli_flags(jparser)
    flags = lambda p: {s for a in p._actions for s in a.option_strings}
    assert ({"--sw-kernel", "--sw-pair", "--exact-vq", "--fused-tail"} <= flags(parser)
            <= flags(jparser))
    args = parser.parse_args(["--sw-kernel", "tokens", "--exact-vq", "1", "--fused-tail", "up"])
    knobs.apply_cli_args(args)
    assert knobs.get("SW_KERNEL") == "tokens" and knobs.get("EXACT_VQ") == "1"
    assert knobs.get("SW_PAIR") == "0" and knobs.get("FUSED_TAIL") == "up"
    with pytest.raises(SystemExit):
        parser.parse_args(["--fused-tail", "2"])
    with pytest.raises(SystemExit):
        parser.parse_args(["--sw-pair", "2"])
    assert "PGT_SW_PAIR" in parser.format_help()


def test_exact_vq_knob_on_cpu_is_the_exact_argmin():
    """On the CPU both settings run argmin(compute_distances)."""
    import pgtformer_tpu_torch.models.quantizer as tq
    w = t(RNG.normal(size=(33, 16)))
    x = t(RNG.normal(size=(5, 7, 16)))
    a = tq.find_nearest_embedding(w, x)
    knobs.set_knob("EXACT_VQ", "1")
    assert torch.equal(tq.find_nearest_embedding(w, x), a)
    assert torch.equal(a, tq.compute_distances(w, x).argmin(-1))
