"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at the widths of the serving step and of the code path.

Needs an NVIDIA GPU: every test decides inside itself whether a card exists
and skips with a reason when there is none.  On a machine with a card (no
JAX needed; the repo's conftest imports JAX, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: max|kernel - plain| <= 2e-2 * max|plain| for K1 (the plain
version rounds every intermediate to bf16, the kernel keeps the residual
and LayerNorm in fp32) and <= 1e-2 * max|plain| for K2 (probabilities are
rounded to bf16 before normalization in the kernel, after it in the plain
version), both layouts.  K3 (token entry) is held to K1's tolerance and to
bit-equality with K1 on the same windows; K4 (pair) to bit-equality with two
K1 launches.  K5 (nearest code, fp32) must agree with its plain version on
>= 0.999 of rows, and wherever it differs the two choices' fp64 distances
must lie within 1e-5 relative of each other.
"""

import numpy as np
import pytest
import torch

from pgtformer_tpu_torch.nn.blocks import EncoderLayer, SWTransformerBlock, init_weights
from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops.dense_mha import (
    dense_mha, dense_mha_bhnd, dense_mha_bnhd, dense_mha_plain)
from pgtformer_tpu_torch.ops.sw_block import (
    sw_block, sw_block_pair, sw_block_pair_plain, sw_block_plain, sw_block_tokens,
    sw_block_tokens_plain)
from pgtformer_tpu_torch.ops.vq import nearest_code, nearest_code_plain
from pgtformer_tpu_torch.ops.window import (
    shifted_window_mask, window_partition, window_reverse)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda")


def _block_weights(C, heads, T, seed):
    g = torch.Generator().manual_seed(seed)
    blk = init_weights(SWTransformerBlock(C, heads, T, (4, 4), (0, 0), 1.0), g)
    with torch.no_grad():
        for p in blk.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return blk


@pytest.mark.parametrize("shape,shift", [
    ((8, 3, 128, 128, 256), (0, 0)), ((8, 3, 128, 128, 256), (2, 2)),
    ((8, 3, 64, 64, 256), (2, 2)), ((8, 3, 32, 32, 512), (0, 0)),
    ((8, 3, 32, 32, 512), (2, 2)), ((2, 3, 16, 16, 64), (2, 2))])
def test_sw_block_kernel_matches_plain(shape, shift):
    dev = _card()
    heads = 8 if shape[-1] >= 256 else 4
    w = _block_weights(shape[-1], heads, shape[1], seed=1).to(dev).kernel_weights(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    before = sw_block.launches
    out = sw_block(x, w, shift)
    assert sw_block.launches == before + 1
    ref = sw_block_plain(x, w, shift)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("B,H,N,D", [(8, 8, 3072, 64), (2, 4, 768, 16), (1, 2, 200, 32)])
def test_dense_mha_kernel_matches_plain(B, H, N, D):
    dev = _card()
    C = H * D
    g = torch.Generator().manual_seed(3)
    qk = (torch.randn((B, N, 2 * C), generator=g) * 1.5).to(dev, torch.bfloat16)
    v = torch.randn((B, N, C), generator=g).to(dev, torch.bfloat16)
    split = lambda a: a.reshape(B, N, H, D)
    q, k, v = split(qk[..., :C]), split(qk[..., C:]), split(v)
    heads = lambda a: a.transpose(1, 2)
    ref = dense_mha_plain(heads(q), heads(k), heads(v), D ** -0.5)      # [B, H, N, D]
    before = dense_mha_bnhd.launches, dense_mha_bhnd.launches
    packed = dense_mha(q, k, v, scale=D ** -0.5, layout="bnhd")
    assert packed.shape == (B, N, H, D) and packed.is_contiguous()
    out = dense_mha(heads(q), heads(k), heads(v), scale=D ** -0.5, layout="bhnd")
    assert out.shape == (B, H, N, D) and out.is_contiguous()
    assert (dense_mha_bnhd.launches, dense_mha_bhnd.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(heads(packed), out)          # one kernel, two layouts
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err


def test_kernels_refuse_instead_of_falling_back():
    dev = _card()
    w = _block_weights(64, 4, 3, seed=1).to(dev).kernel_weights(dev)
    with pytest.raises(NotImplementedError):
        sw_block(torch.zeros((1, 3, 8, 8, 64), device=dev), w, (0, 0))      # fp32
    with pytest.raises(NotImplementedError):
        EncoderLayer(64, 2, 4, 3, (4, 4), 1.0).to(dev, torch.bfloat16)(
            torch.zeros((1, 3, 6, 6, 64), device=dev, dtype=torch.bfloat16))
    q = torch.zeros((1, 12, 4, 16), device=dev, dtype=torch.bfloat16)
    for layout in ("bnhd", "bhnd"):
        with pytest.raises(NotImplementedError):
            dense_mha(q, q, q, scale=0.25, layout=layout)                    # N % 8
    q = torch.zeros((1, 16, 4, 16), device=dev)
    with pytest.raises(NotImplementedError):
        dense_mha(q, q, q, scale=0.25, layout="bnhd")                        # fp32
    tok = torch.zeros((4, 48, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        sw_block_tokens(tok, w, np.zeros((4, 48, 48), np.float32), 4)        # host mask
    with pytest.raises(NotImplementedError):
        sw_block_tokens(tok.float(), w, None, 4)
    with pytest.raises(NotImplementedError):
        sw_block_pair(torch.zeros((1, 3, 8, 8, 64), device=dev), w, w, (2, 2))
    x = torch.zeros((8, 64), device=dev)
    with pytest.raises(NotImplementedError):
        nearest_code(x.to(torch.bfloat16), x.to(torch.bfloat16))
    with pytest.raises(NotImplementedError):
        nearest_code(x[:, :6].contiguous(), x[:, :6].contiguous())          # D % 4


def test_encoder_layer_cuda_matches_cpu():
    """The layer on the card (kernel, bf16) against the layer on the CPU
    (plain version, fp32), same weights."""
    dev = _card()
    cpu = init_weights(EncoderLayer(128, 2, 4, 3, (4, 4), 1.0),
                       torch.Generator().manual_seed(5)).eval()
    x = torch.randn((2, 3, 16, 16, 128), generator=torch.Generator().manual_seed(6))
    gpu = EncoderLayer(128, 2, 4, 3, (4, 4), 1.0)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev, torch.bfloat16)
    with torch.no_grad():
        ref = cpu(x)
        out = gpu(x.to(dev, torch.bfloat16)).float().cpu()
    err = np.abs(out.numpy() - ref.numpy())
    assert err.mean() <= 2e-2 * np.abs(ref.numpy()).mean(), err.mean()


@pytest.mark.parametrize("shape,shift", [
    ((8, 3, 64, 64, 256), (0, 0)), ((8, 3, 64, 64, 256), (2, 2)),
    ((8, 3, 32, 32, 512), (2, 2)), ((2, 3, 16, 16, 64), (2, 2))])
def test_sw_block_tokens_kernel(shape, shift):
    """K3 on rolled, partitioned windows with the explicit mask: within K1's
    tolerance of its plain version, and bit-equal to K1 on the 5-D layout."""
    dev = _card()
    B, T, H, W, C = shape
    heads = 8 if C >= 256 else 4
    w = _block_weights(C, heads, T, seed=1).to(dev).kernel_weights(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    shifted = any(shift)
    rolled = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
    tok = window_partition(rolled, (4, 4)).contiguous()
    nW = (H // 4) * (W // 4)
    mask = (torch.as_tensor(shifted_window_mask(T, H, W, (4, 4), shift), device=dev)
            if shifted else None)
    before = sw_block_tokens.launches
    out = sw_block_tokens(tok, w, mask, nW)
    assert sw_block_tokens.launches == before + 1
    ref = sw_block_tokens_plain(tok, w, mask, nW)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), err
    back = window_reverse(out, (4, 4), B, T, H, W)
    if shifted:
        back = torch.roll(back, shift, dims=(2, 3))
    assert torch.equal(back, sw_block(x, w, shift))


@pytest.mark.parametrize("shape", [(8, 3, 128, 128, 256), (8, 3, 32, 32, 512),
                                   (2, 3, 16, 16, 64), (1, 3, 4, 8, 64)])
def test_sw_block_pair_kernel(shape):
    """K4: bit-equal to two K1 launches, and within K1's tolerance of the
    plain pair."""
    dev = _card()
    C = shape[-1]
    heads = 8 if C >= 256 else 4
    w0 = _block_weights(C, heads, shape[1], seed=1).to(dev).kernel_weights(dev)
    w1 = _block_weights(C, heads, shape[1], seed=2).to(dev).kernel_weights(dev)
    shift = (0, 2) if shape[2] == 4 else (2, 2)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(dev, torch.bfloat16)
    before = sw_block_pair.launches, sw_block.launches
    out = sw_block_pair(x, w0, w1, shift)
    assert (sw_block_pair.launches, sw_block.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, sw_block(sw_block(x, w0, (0, 0)), w1, shift))
    ref = sw_block_pair_plain(x, w0, w1, shift)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), err


@pytest.mark.parametrize("N,n,D", [(24576, 1024, 512), (1000, 1024, 512), (257, 100, 36)])
def test_nearest_code_kernel(N, n, D):
    dev = _card()
    g = torch.Generator().manual_seed(4)
    x = torch.randn((N, D), generator=g).to(dev)
    codes = torch.randn((n, D), generator=g).to(dev)
    before = nearest_code.launches
    out = nearest_code(x, codes)
    assert nearest_code.launches == before + 1
    assert out.dtype == torch.int64 and out.shape == (N,)
    assert 0 <= int(out.min()) and int(out.max()) < n
    ref = nearest_code_plain(x, codes)
    differ = torch.nonzero(out != ref).flatten()
    assert len(differ) <= 1e-3 * N, len(differ)
    xd = x[differ].double()
    dist = lambda idx: ((xd - codes[idx[differ]].double()) ** 2).sum(-1)
    a, b = dist(out), dist(ref)
    assert bool(((a - b).abs() <= 1e-5 * b).all())


def test_nearest_code_kernel_exact_tie_takes_lower_index():
    dev = _card()
    g = torch.Generator().manual_seed(5)
    codes = torch.randn((1024, 512), generator=g)
    codes[900] = codes[130]                 # a later tile of 128 codes,
    codes[200] = codes[130]                 # another thread of the same tile,
    codes[131] = codes[130]                 # and the same thread's next code
    x = codes[130][None] + 0.01 * torch.randn((64, 512), generator=g)
    out = nearest_code(x.to(dev), codes.to(dev))
    assert bool((out == 130).all())


def test_encoder_layer_plans_on_the_card():
    """tokens and pair plans of EncoderLayer equal the default plan bit for
    bit on the card (one device function), with the right launches."""
    dev = _card()
    layer = init_weights(EncoderLayer(128, 2, 4, 3, (4, 4), 1.0),
                         torch.Generator().manual_seed(5)).to(dev, torch.bfloat16).eval()
    x = torch.randn((2, 3, 16, 16, 128), generator=torch.Generator().manual_seed(6))
    x = x.to(dev, torch.bfloat16)
    try:
        with torch.no_grad():
            ref = layer(x)
            knobs.set_knob("SW_KERNEL", "tokens")
            n0 = sw_block_tokens.launches
            tok = layer(x)
            assert sw_block_tokens.launches == n0 + 2
            knobs.reset()
            knobs.set_knob("SW_PAIR", "1")
            n0 = sw_block_pair.launches
            pair = layer(x)
            assert sw_block_pair.launches == n0 + 1
    finally:
        knobs.reset()
    assert torch.equal(tok, ref) and torch.equal(pair, ref)


def test_quantizer_on_the_card_uses_the_kernel_unless_exact():
    dev = _card()
    from pgtformer_tpu_torch.models.quantizer import RQBottleneck
    rq = init_weights(RQBottleneck((8, 8, 64), (8, 8, 2), 128, shared_codebook=False),
                      torch.Generator().manual_seed(7)).to(dev, torch.bfloat16)
    assert rq.codebooks[0].weight.dtype == torch.float32
    x = torch.randn((4, 8, 8, 64), generator=torch.Generator().manual_seed(8))
    x = x.to(dev, torch.bfloat16)
    try:
        n0 = nearest_code.launches
        q, loss, codes = rq(x)
        assert nearest_code.launches == n0 + 2           # one per depth
        knobs.set_knob("EXACT_VQ", "1")
        q2, _, codes2 = rq(x)
        assert nearest_code.launches == n0 + 2
    finally:
        knobs.reset()
    assert q.dtype == torch.bfloat16 and bool(torch.isfinite(loss))
    assert (codes == codes2).float().mean().item() >= 0.999
