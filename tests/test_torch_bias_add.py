"""The convs' bias pass of the PyTorch port on the CPU: the plain version of
``ops/bias_add.py`` (ATen's chain: the bias rounded to the activation's
dtype and added, then the residual), the decision of which convs take the
pass (bf16 on the card with no gradient recorded; here every module keeps
its own call, its launch counter still), and, with that decision forced
on for bf16 CPU tensors, every module that routes a bias through the pass
held bit for bit to the chain the card runs: the conv without its bias,
the bias added in place, then the residual.  The kernel itself runs only
on the card (tests/test_torch_kernels_cuda.py)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

import pgtformer_tpu_torch.nn.blocks as blocks
from pgtformer_tpu_torch.models.vqgan import AttnBlock2D
from pgtformer_tpu_torch.nn.blocks import (
    Downsample, Float32Conv2d, ResnetBlock, Upsample, _fold, _unfold, bias_apart, conv_nhwc,
    subpixel_kernel, subpixel_up_conv)
from pgtformer_tpu_torch.ops.bias_add import bias_add, bias_add_plain

BF = torch.bfloat16


def _t(shape, seed, scale=1.0, dtype=BF):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.int16), b.contiguous().view(torch.int16))


def _seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.1 if p.dim() > 1 else 0.7))
    return module


@pytest.mark.parametrize("bias_dtype", [BF, torch.float32])
@pytest.mark.parametrize("residual", ["none", "dense", "middle_frame"])
@pytest.mark.parametrize("shape", [(3, 5, 7, 64), (2, 4, 4, 3), (1, 1, 1, 512)])
def test_plain_version_is_atens_chain(shape, residual, bias_dtype):
    h = _t(shape, 1, 3.0)
    b = _t(shape[-1], 2, dtype=bias_dtype)
    r = None
    if residual != "none":
        clip = _t((shape[0], 3, *shape[1:]), 3)
        r = clip[:, 1] if residual == "middle_frame" else clip[:, 1].contiguous()
    want = h + b.to(BF)
    want = want if r is None else r + want
    n0 = bias_add.launches
    for fn in (bias_add_plain, bias_add):
        got = fn(h.clone(), b, r)
        _bits_equal(got, want)
    assert bias_add.launches == n0


def test_plain_version_adds_in_place():
    h = _t((2, 3, 3, 8), 4)
    out = bias_add_plain(h, _t(8, 5), _t((2, 3, 3, 8), 6))
    assert out.data_ptr() == h.data_ptr()


@pytest.mark.parametrize("dtype,is_cuda,grad,want", [
    (BF, True, False, True), (BF, True, True, False), (torch.float32, True, False, False),
    (BF, False, False, False), (torch.float16, True, False, False)])
def test_bias_apart_only_for_bf16_on_the_card_without_gradient(dtype, is_cuda, grad, want):
    x = SimpleNamespace(dtype=dtype, is_cuda=is_cuda)
    with torch.set_grad_enabled(grad):
        assert bias_apart(x) is want


def test_cpu_modules_keep_their_own_call():
    """Off the card the conv keeps its bias (oneDNN fuses it), and
    conv_nhwc's residual is ATen's `residual + y`; no launch."""
    conv = _seeded(torch.nn.Conv2d(16, 24, 3, padding=1), 7).to(BF)
    x, r = _t((2, 6, 5, 16), 8), _t((2, 6, 5, 24), 9)
    n0 = bias_add.launches
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            y = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            _bits_equal(conv_nhwc(conv, x), y)
            _bits_equal(conv_nhwc(conv, x, residual=r), r + y)
    f32 = _seeded(Float32Conv2d(16, 24, 1), 10).to(BF)
    with torch.no_grad():
        want = F.conv2d(x.permute(0, 3, 1, 2), f32.weight.to(BF), f32.bias.to(BF))
        _bits_equal(f32(x.permute(0, 3, 1, 2)), want)
    assert bias_add.launches == n0


@pytest.fixture
def card_path(monkeypatch):
    """The card's decision for bf16 CPU tensors: their convs run without
    the bias, which the plain version then adds."""
    monkeypatch.setattr(blocks, "bias_apart", lambda x: x.dtype == BF)


def _chain(conv, xc, residual=None, **kw):
    """The card's chain on an NCHW input, as [N, H, W, C]: the conv without
    its bias, the bias rounded to bf16 and added, then the residual."""
    y = F.conv2d(xc, conv.weight.to(BF), None, conv.stride, conv.padding, **kw)
    y = y.permute(0, 2, 3, 1) + conv.bias.to(BF)
    return y if residual is None else residual + y


@pytest.mark.parametrize("residual", ["none", "dense", "middle_frame"])
def test_conv_nhwc_on_the_card_path(card_path, residual):
    conv = _seeded(torch.nn.Conv2d(16, 24, 3, padding=1), 11).to(BF)
    x = _t((3, 6, 5, 16), 12)
    r = None if residual == "none" else _t((3, 3, 6, 5, 24), 13)[:, 1]
    if residual == "dense":
        r = r.contiguous()
    with torch.no_grad():
        got = conv_nhwc(conv, x, residual=r)
        _bits_equal(got, _chain(conv, x.permute(0, 3, 1, 2), r))


def test_fp32_weight_conv_and_downsample_on_the_card_path(card_path):
    f32 = _seeded(Float32Conv2d(16, 24, 3, padding=1), 14).to(BF)
    down = _seeded(Downsample(16), 15).to(BF)
    x = _t((2, 8, 6, 16), 16)
    xc = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        _bits_equal(f32(xc), _chain(f32, xc).permute(0, 3, 1, 2))
        _bits_equal(down(x), _chain(down.conv, F.pad(xc, (0, 1, 0, 1))))


@pytest.mark.parametrize("cin,cout,five_d", [(32, 32, False), (32, 64, True), (64, 32, False)])
def test_resnet_block_folds_its_residual_on_the_card_path(card_path, cin, cout, five_d):
    blk = _seeded(ResnetBlock(cin, cout), cin + cout).to(BF)
    x = _t((2, 3, 6, 6, cin) if five_d else (3, 6, 6, cin), 17)
    with torch.no_grad():
        got = blk(x)
        xf, lead = _fold(x)
        h = _chain(blk.conv1, blk.norm1(xf, silu=True).permute(0, 3, 1, 2))
        sc = _chain(blk.nin_shortcut, xf.permute(0, 3, 1, 2)) if cin != cout else xf
        want = _chain(blk.conv2, blk.norm2(h, silu=True).permute(0, 3, 1, 2), sc)
    _bits_equal(got, _unfold(want, lead))


@pytest.mark.parametrize("subpixel", [True, False])
def test_upsample_on_the_card_path(monkeypatch, subpixel):
    """The phase convs (the CPU's plan) and the `dilated` transposed conv
    (called directly) run without a bias in any case: through the pass
    they give what they gave before, bit for bit; the VQGAN family's
    nearest upsample + fp32-weight conv gives the card's chain."""
    up = _seeded(Upsample(16, subpixel=subpixel), 18).to(BF)
    x = _t((2, 5, 4, 16), 19)
    k = subpixel_kernel(up.conv.weight.float(), "dilated").to(BF).contiguous()
    b = up.conv.bias.to(BF)
    runs = []
    for patched in (False, True):
        if patched:
            monkeypatch.setattr(blocks, "bias_apart", lambda t: t.dtype == BF)
        with torch.no_grad():
            runs.append((up(x), subpixel_up_conv(x, k, b, "dilated")))
    (up_before, dilated_before), (got, dilated) = runs
    if not subpixel:
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        up_before = _chain(up.conv, y)
    _bits_equal(got, up_before)
    _bits_equal(dilated, dilated_before)


def test_attention_block_folds_its_residual_on_the_card_path(card_path):
    blk = _seeded(AttnBlock2D(32), 20).to(BF)
    x = _t((2, 4, 4, 32), 21)
    with torch.no_grad():
        got = blk(x)
        seen = {}
        orig = blocks.bias_add

        def spy(h, bias, residual=None):
            seen[bias.data_ptr()] = residual
            return orig(h, bias, residual)
        blocks.bias_add = spy
        try:
            again = blk(x)
        finally:
            blocks.bias_add = orig
    _bits_equal(got, again)
    assert seen[blk.proj_out.bias.data_ptr()] is x
    assert all(seen[c.bias.data_ptr()] is None for c in (blk.q, blk.k, blk.v))


def test_hooked_conv_keeps_its_module_call_on_the_card_path(card_path):
    """A conv with a forward hook runs as a module call, so the hook sees
    it once: nn.Conv2d keeps ATen's fused bias, the fp32-weight conv takes
    the pass inside its own forward."""
    conv = _seeded(torch.nn.Conv2d(16, 24, 1), 24).to(BF)
    f32 = _seeded(Float32Conv2d(16, 24, 1), 25).to(BF)
    x = _t((2, 3, 4, 16), 26)
    seen = []
    for m in (conv, f32):
        m.register_forward_pre_hook(lambda mod, a: seen.append(mod))
    with torch.no_grad():
        _bits_equal(conv_nhwc(conv, x), conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        del seen[-1]
        _bits_equal(conv_nhwc(f32, x), _chain(f32, x.permute(0, 3, 1, 2)))
    assert seen == [conv, f32]


def test_wrapper_refuses_what_it_does_not_take():
    h = _t((2, 4, 4, 8), 22)
    with pytest.raises(ValueError):
        bias_add(h, _t(4, 23))
    with pytest.raises(ValueError):
        bias_add(h, _t(8, 23), _t((2, 4, 4, 4), 24))
    with pytest.raises(ValueError):
        bias_add(_t((2, 4, 8), 25), _t(8, 23))
    with pytest.raises(NotImplementedError):
        bias_add(torch.empty((2, 4, 4, 8), dtype=BF, device="meta"),
                 torch.empty(8, dtype=BF, device="meta"))
