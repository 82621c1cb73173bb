"""The bf16 GroupNorm (+ SiLU) of the PyTorch port on the CPU: the plain
path of ``ops/group_norm.py`` and every module that calls it, held bit for
bit to the chain the port ran before the kernel (sum and vector_norm
statistics, ``gn_affine_from_stats``, an ``addcmul`` rounded once, then
``F.silu``).  The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py); on the CPU its launch counter stays
still.  The fp32 path and a recorded gradient keep their old code."""

import pytest
import torch
import torch.nn.functional as F

from pgtformer_tpu_torch.models.vqgan import _SeqTower
from pgtformer_tpu_torch.nn.blocks import GroupNorm, ResnetBlock, _fold, _unfold, conv_nhwc
from pgtformer_tpu_torch.ops.group_norm import group_norm_silu

BF = torch.bfloat16


def _chain(x, weight, bias, silu, groups=32, eps=1e-6):
    """The bf16 GroupNorm as the port computed it before the kernel."""
    N, H, W, C = x.shape
    s1 = x.sum((1, 2), dtype=torch.float32)
    s2 = torch.linalg.vector_norm(x, 2, (1, 2), dtype=torch.float32).square()
    cg = C // groups
    mu = s1.reshape(N, groups, cg).sum(-1) / (H * W * cg)
    var = s2.reshape(N, groups, cg).sum(-1) / (H * W * cg) - mu * mu
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cg, dim=1) * weight.float()[None]
    b = bias.float()[None] - mu.repeat_interleave(cg, dim=1) * a
    y = torch.addcmul(b[:, None, None], x, a[:, None, None], out=torch.empty_like(x))
    return F.silu(y) if silu else y


def _norm(C, seed):
    g = torch.Generator().manual_seed(seed)
    m = GroupNorm(C)
    with torch.no_grad():
        m.weight.copy_(1.0 + 0.3 * torch.randn(C, generator=g))
        m.bias.copy_(0.2 * torch.randn(C, generator=g))
    return m.to(BF)


def _x(shape, seed, offset=0.3):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 1.7 + offset).to(BF)


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# (name, x [N, H, W, C] as the module gets it): group sizes 2, 9 and 33
CASES = {
    "4d_group2": lambda: _x((3, 8, 6, 64), 1),
    "4d_group9": lambda: _x((2, 5, 7, 288), 2, offset=-1.5),
    "4d_group33": lambda: _x((2, 4, 4, 1056), 3),
    "folded_5d_group2": lambda: _fold(_x((2, 3, 8, 8, 64), 4))[0],
    "folded_5d_group9": lambda: _fold(_x((1, 3, 6, 4, 288), 5))[0],
    "middle_frame_group33": lambda: _fold(_x((4, 3, 4, 6, 1056), 6)[:, 1:2])[0],
    "middle_frame_group2": lambda: _fold(_x((3, 3, 8, 8, 64), 7)[:, 1:2])[0],
}


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_group_norm_silu_equals_the_old_chain(case, silu):
    x = CASES[case]()
    C = x.shape[-1]
    m = _norm(C, seed=len(case))
    n0 = group_norm_silu.launches
    with torch.no_grad():
        want = _chain(x, m.weight, m.bias, silu)
        got_fn = group_norm_silu(x, m.weight, m.bias, silu)
        got_mod = m(x, silu=silu)
        with torch.inference_mode():
            got_inf = m(x, silu=silu)
    for got in (got_fn, got_mod, got_inf):
        _bits_equal(got, want)
    assert group_norm_silu.launches == n0


def test_middle_frame_slice_is_strided():
    """The case above hands the norm a view with a batch stride, as the
    decoder's middle-frame slice does."""
    x = CASES["middle_frame_group33"]()
    assert x.stride(0) == 3 * x.shape[1] * x.shape[2] * x.shape[3] and not x.is_contiguous()


@pytest.mark.parametrize("silu", [False, True])
def test_fp32_path_is_torchs_group_norm(silu):
    m = _norm(64, 11).float()
    x = _x((2, 6, 5, 64), 12).float()
    with torch.no_grad():
        got = m(x, silu=silu)
    want = F.group_norm(x.permute(0, 3, 1, 2), 32, m.weight, m.bias, 1e-6).permute(0, 2, 3, 1)
    want = F.silu(want) if silu else want
    assert torch.equal(got, want)


@pytest.mark.parametrize("silu", [False, True])
def test_recorded_gradient_path_is_the_old_chain(silu):
    """Under a recorded gradient (training in bf16) the module runs the old
    chain, and its gradients are the chain's."""
    m = _norm(288, 13)
    x0 = _x((2, 5, 4, 288), 14)
    cot = _x((2, 5, 4, 288), 15)
    res = []
    for run in (lambda x: m(x, silu=silu), lambda x: _chain_grad(x, m, silu)):
        m.zero_grad(set_to_none=True)
        x = x0.clone().requires_grad_()
        y = run(x)
        y.backward(cot)
        res.append((y.detach(), x.grad, m.weight.grad, m.bias.grad))
    for got, want in zip(*res):
        _bits_equal(got, want)


def _chain_grad(x, m, silu):
    """The old chain under autograd: the affine in fp32, then cast."""
    N, H, W, C = x.shape
    s1 = x.sum((1, 2), dtype=torch.float32)
    s2 = torch.linalg.vector_norm(x, 2, (1, 2), dtype=torch.float32).square()
    cg = C // 32
    mu = s1.reshape(N, 32, cg).sum(-1) / (H * W * cg)
    var = s2.reshape(N, 32, cg).sum(-1) / (H * W * cg) - mu * mu
    inv = torch.rsqrt(var + 1e-6)
    a = inv.repeat_interleave(cg, dim=1) * m.weight.float()[None]
    b = m.bias.float()[None] - mu.repeat_interleave(cg, dim=1) * a
    y = torch.addcmul(b[:, None, None], x, a[:, None, None]).to(x.dtype)
    return F.silu(y) if silu else y


@pytest.mark.parametrize("cin,cout,five_d", [(64, 64, True), (64, 96, False), (288, 64, True)])
def test_resnet_block_runs_norm_and_silu_as_one_call(cin, cout, five_d):
    g = torch.Generator().manual_seed(cin + cout)
    blk = ResnetBlock(cin, cout)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.1 if p.dim() > 1 else 0.5))
    blk = blk.to(BF)
    x = _x((2, 3, 6, 6, cin) if five_d else (3, 6, 6, cin), 16)
    with torch.no_grad():
        got = blk(x)
        xf, lead = _fold(x)
        h = conv_nhwc(blk.conv1, _chain(xf, blk.norm1.weight, blk.norm1.bias, True))
        h = conv_nhwc(blk.conv2, _chain(h, blk.norm2.weight, blk.norm2.bias, True))
        sc = conv_nhwc(blk.nin_shortcut, xf) if cin != cout else xf
        want = _unfold(sc + h, lead)
    _bits_equal(got, want)


@pytest.mark.parametrize("taps", [(), (1,)])
def test_seq_tower_fuses_norm_then_silu(taps):
    """A tower's norm followed by silu is one call of the norm; a tapped
    norm keeps its own output."""
    specs = (("conv", 64), ("norm", None), ("silu", None), ("conv", 32))
    tower = _SeqTower(specs, 3)
    g = torch.Generator().manual_seed(17)
    with torch.no_grad():
        for p in tower.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    tower = tower.to(BF)
    x = _x((2, 8, 8, 3), 18)
    with torch.no_grad():
        out = tower(x, taps=taps)
        h = conv_nhwc(tower.blocks[0], x)
        n = _chain(h, tower.blocks[1].weight, tower.blocks[1].bias, False)
        want = conv_nhwc(tower.blocks[3], F.silu(n))
    if taps:
        out, tapped = out
        _bits_equal(tapped[1], n)
    _bits_equal(out, want)


def test_wrapper_refuses_what_it_does_not_take():
    m = _norm(64, 19)
    with pytest.raises(ValueError):
        group_norm_silu(_x((2, 4, 4, 64), 20), m.weight[:32], m.bias)
    with pytest.raises(ValueError):
        group_norm_silu(_x((2, 4, 64), 20), m.weight, m.bias)
    with pytest.raises(NotImplementedError):
        group_norm_silu(torch.empty((2, 4, 4, 64), dtype=BF, device="meta"),
                        m.weight.to("meta"), m.bias.to("meta"))
