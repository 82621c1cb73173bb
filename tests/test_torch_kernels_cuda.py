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
version), both layouts, at the cases of MHA_CASES; two launches and the
two layouts bit-equal.  K3 (token entry) is held to K1's tolerance and to
bit-equality with K1 on the same windows; K4 (pair) to bit-equality with two
K1 launches.  K5 (nearest code, fp32) must agree with its plain version on
>= 0.999 of rows, and wherever it differs the two choices' fp64 distances
must lie within 1e-5 relative of each other.  K7 (gn_silu_conv3x3) and K8
(subpixel_up_conv3x3): max|kernel - plain| <= 1e-2 * max|plain| (one bf16 ulp
of the output where fp32 sums in another order round the other way), the
emitted statistics within 1e-3 of the largest per-channel value of their
kind; the plain versions multiply in fp32, so TF32 is switched off for them.

Gradients: each kernel's autograd Function (kernel forward, the plain
version's backward) against autograd through the plain version, x in bf16
and fp32 master weights as in training: the forward to the kernel's
tolerance above, every gradient within 1e-3 of its largest magnitude (both
run the same backward graph on the same saved inputs, so only cuBLAS's and
the scatter-adds' summation order differs), one launch per forward and none
in the backward.  A small bf16 Stage1Trainer step on the card against the
same step in fp32 on the CPU: every metric within 5e-2 of max(|CPU value|,
0.1) (bf16 compute through the whole autoencoder, discriminator and LPIPS).
A checkpoint of that trainer on the card restores bit for bit (modules,
EMA, Adam's device tensors, schedulers, the CUDA generator), and the next
step after the restore meets the same metric tolerance against the step
taken without the save.  Two ranks on the one card (gloo, spawned, the
collectives staged through host memory) serve the small model bit-equal
to one process at B/2.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import EncoderLayer, SWTransformerBlock, init_weights
from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops.dense_mha import (
    dense_mha, dense_mha_bhnd, dense_mha_bnhd, dense_mha_plain)
from pgtformer_tpu_torch.ops.fused_conv import (
    channel_stats, gn_affine_from_stats, gn_silu_conv3x3, gn_silu_conv3x3_plain,
    subpixel_up_conv3x3, subpixel_up_conv3x3_plain)
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


# Ragged last CTAs (a slab count no multiple of the two slabs a CTA holds
# at C <= 256), partial last slabs, T=1 windows (N=16: three windows per
# slab) and head widths 16, 32 and 64: (shape, heads, shift).
RAGGED_K1 = [((1, 3, 4, 4, 64), 4, (0, 0)), ((1, 3, 4, 12, 256), 8, (2, 2)),
             ((1, 3, 8, 12, 64), 4, (2, 2)),
             ((1, 3, 8, 12, 128), 4, (2, 2)), ((1, 3, 8, 12, 256), 4, (2, 2)),
             ((1, 3, 4, 4, 512), 8, (0, 0)), ((1, 3, 8, 12, 512), 8, (2, 2)),
             ((1, 1, 4, 28, 256), 8, (2, 2)), ((3, 1, 12, 20, 64), 2, (0, 2)),
             ((1, 1, 8, 12, 512), 16, (2, 2))]


@pytest.mark.parametrize("shape,heads,shift", RAGGED_K1)
def test_sw_block_kernel_ragged(shape, heads, shift):
    dev = _card()
    w = _block_weights(shape[-1], heads, shape[1], seed=3).to(dev).kernel_weights(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(dev, torch.bfloat16)
    out = sw_block(x, w, shift)
    ref = sw_block_plain(x, w, shift)
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), err
    assert torch.equal(sw_block(x, w, shift), out)            # no atomics


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape,heads", [((1, 3, 8, 12, 256), 8), ((3, 1, 12, 20, 64), 2)])
def test_sw_block_tokens_kernel_ragged(shape, heads, masked):
    """K3 at ragged window counts, with the caller's mask and without."""
    dev = _card()
    B, T, H, W, C = shape
    w = _block_weights(C, heads, T, seed=5).to(dev).kernel_weights(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(dev, torch.bfloat16)
    tok = window_partition(x, (4, 4)).contiguous()
    nW = (H // 4) * (W // 4)
    mask = (torch.as_tensor(shifted_window_mask(T, H, W, (4, 4), (2, 2)), device=dev)
            if masked else None)
    out = sw_block_tokens(tok, w, mask, nW)
    ref = sw_block_tokens_plain(tok, w, mask, nW)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item(), err
    if not masked:
        assert torch.equal(window_reverse(out, (4, 4), B, T, H, W), sw_block(x, w, (0, 0)))


@pytest.mark.parametrize("shape", [(1, 3, 8, 12, 256), (1, 3, 8, 12, 512)])
def test_sw_block_pair_kernel_ragged(shape):
    dev = _card()
    C = shape[-1]
    w0 = _block_weights(C, 8, 3, seed=7).to(dev).kernel_weights(dev)
    w1 = _block_weights(C, 8, 3, seed=8).to(dev).kernel_weights(dev)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(9)).to(dev, torch.bfloat16)
    out = sw_block_pair(x, w0, w1, (2, 2))
    assert torch.equal(out, sw_block(sw_block(x, w0, (0, 0)), w1, (2, 2)))


# (B, H, N, D, kind) of the attention kernel's cases: the code transformer's
# shape, partial query and key tiles (N not a multiple of 128; N=8, one
# partial tile of each), D=32 (its scale 2^-2.5 is no power of two) and
# D=16; "negative" makes every logit about -9*sqrt(D), so an unmasked
# zero-filled key (logit 0) would take the softmax; "sharp" multiplies the
# logits by 30, so the running max moves by far from tile to tile.
MHA_CASES = [(8, 8, 3072, 64, "normal"), (2, 4, 768, 16, "normal"), (1, 2, 200, 32, "normal"),
             (1, 2, 200, 64, "normal"), (2, 2, 136, 64, "normal"), (1, 2, 8, 64, "normal"),
             (2, 4, 768, 32, "normal"), (1, 2, 200, 64, "negative"), (2, 2, 520, 64, "sharp")]


def mha_operands(B, H, N, D, kind):
    """fp32 CPU operands, made with numpy from a seed, as the serving step
    lays them out: q and k are the halves of one packed [B, N, 2C]
    projection, v its own [B, N, C]."""
    C = H * D
    rng = np.random.default_rng(3)
    qk = rng.standard_normal((B, N, 2 * C), dtype=np.float32) * 1.5
    v = rng.standard_normal((B, N, C), dtype=np.float32)
    if kind == "negative":
        qk = qk * 0.2
        qk[..., :C] += 3.0
        qk[..., C:] -= 3.0
    elif kind == "sharp":
        qk[..., :C] *= 30.0
    return torch.from_numpy(qk), torch.from_numpy(v)


@pytest.mark.parametrize("B,H,N,D,kind", MHA_CASES)
def test_dense_mha_kernel_matches_plain(B, H, N, D, kind):
    dev = _card()
    C = H * D
    qk, v = (a.to(dev, torch.bfloat16) for a in mha_operands(B, H, N, D, kind))
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
    assert torch.isfinite(out).all()
    assert torch.equal(heads(packed), out)          # one kernel, two layouts
    assert torch.equal(dense_mha(q, k, v, scale=D ** -0.5, layout="bnhd"), packed)  # no atomics
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


@pytest.mark.parametrize("N,n,D", [(24576, 1024, 512), (63, 129, 20), (65, 127, 516),
                                   (130, 1, 4), (1, 300, 12)])
def test_nearest_code_kernel_ties_across_tiles_and_threads(N, n, D):
    """Exact ties between codes in different 128-code tiles, different
    threads of one tile (codes 4 apart), one thread's two halves (64 apart)
    and one thread's neighbours; rows near the tied code.  The lowest index
    wins; every other row agrees with the plain version up to near-ties."""
    dev = _card()
    g = torch.Generator().manual_seed(10)
    codes = torch.randn((n, D), generator=g)
    x = torch.randn((N, D), generator=g)
    if n > 1:
        base = min(3, n - 1)
        twins = [j for j in (base + 1, base + 4, base + 64, base + 128, base + 131, n - 1)
                 if base < j < n]
        for j in twins:
            codes[j] = codes[base]
        near = codes[base][None] + 0.01 * torch.randn((min(N, 70), D), generator=g)
        x[:near.shape[0]] = near
    out = nearest_code(x.to(dev), codes.to(dev)).cpu()
    ref = nearest_code_plain(x, codes)
    if n > 1:
        assert bool((out[:min(N, 70)] == base).all())
    differ = torch.nonzero(out != ref).flatten()
    assert len(differ) <= max(1, 1e-3 * N), len(differ)
    xd = x[differ].double()
    dist = lambda idx: ((xd - codes[idx[differ]].double()) ** 2).sum(-1)
    assert bool(((dist(out) - dist(ref)).abs() <= 1e-5 * dist(ref)).all())


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


def _exact_fp32():
    """The plain versions of K7/K8 multiply bf16 values in fp32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close_conv(out, st, ref, ref_st):
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 1e-2 * ref.float().abs().max().item(), err
    if ref_st is None:
        assert st is None
        return
    rel = (st - ref_st).abs().amax(dim=(0, 2)) / ref_st.abs().amax(dim=(0, 2))
    assert rel.max().item() <= 1e-3, rel


# (N, H, W): the serving step's frame size; a ragged one; fewer 12 x 16 tiles
# (6) than an H100 has SMs; and many tiles per persistent CTA (1,700 over
# 132 SMs, ragged in both directions), where a missing proxy fence between a
# slot's last reads and its refill shows
@pytest.mark.parametrize("N,H,W", [(2, 512, 512), (1, 37, 53), (1, 24, 48), (4, 301, 203)])
@pytest.mark.parametrize("C,Cs,residual,act,emit", [
    (128, 0, False, True, True), (64, 128, False, True, True), (64, 0, False, True, True),
    (64, 0, True, True, True), (128, 0, False, False, False)])
def test_gn_silu_conv3x3_kernel(N, H, W, C, Cs, residual, act, emit):
    """K7 in the fused tail's four forms and as a plain conv, at the serving
    step's frame size and at a ragged one."""
    dev = _card()
    _exact_fp32()
    g = torch.Generator().manual_seed(11)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    bf = torch.bfloat16
    x = (rnd(N, H, W, C) * 0.7 + 0.2).to(dev, bf)
    ab = None
    if act:
        ab = gn_affine_from_stats(channel_stats(x), (1.0 + 0.1 * rnd(C)).to(dev),
                                  (0.1 * rnd(C)).to(dev), H * W)
    k = (rnd(3, 3, C, 64) * (9 * C) ** -0.5).to(dev, bf)
    bias = (0.1 * rnd(64)).to(dev)
    kw = {}
    if Cs:
        kw["shortcut"] = ((rnd(N, H, W, Cs) * 0.7).to(dev, bf),
                          (rnd(Cs, 64) * Cs ** -0.5).to(dev, bf), (0.1 * rnd(64)).to(dev))
    if residual:
        kw["residual"] = (rnd(N, H, W, 64) * 0.7).to(dev, bf)
    before = gn_silu_conv3x3.launches
    out, st = gn_silu_conv3x3(x, ab, k, bias, emit_stats=emit, **kw)
    assert gn_silu_conv3x3.launches == before + 1
    ref, ref_st = gn_silu_conv3x3_plain(x, ab, k, bias, emit_stats=emit, **kw)
    _close_conv(out, st, ref, ref_st)
    again, st2 = gn_silu_conv3x3(x, ab, k, bias, emit_stats=emit, **kw)
    assert torch.equal(again, out) and (st is None or torch.equal(st2, st))   # no atomics


@pytest.mark.parametrize("C,Cs,residual", [(128, 0, False), (64, 128, False), (64, 0, False),
                                           (64, 0, True)])
def test_gn_silu_conv3x3_kernel_border_and_strided_batch(C, Cs, residual):
    """K7 with per-(sample, channel) a and b far from a GroupNorm's: silu(b)
    reaches ~3, so padding before the activation (silu(b) at the border
    instead of 0) or an activation that reads a and b at the wrong channel
    (a swizzled chunk taken for its physical index) misses the tolerance by
    far; and x the middle frame of a clip, a view with a batch stride."""
    dev = _card()
    _exact_fp32()
    g = torch.Generator().manual_seed(13)
    rnd = lambda *shape: torch.randn(shape, generator=g)
    bf = torch.bfloat16
    N, H, W = 3, 29, 45
    clip = (rnd(N, 3, H, W, C) * 0.7).to(dev, bf)
    x = clip[:, 1:2].reshape(N, H, W, C)
    assert not x.is_contiguous()
    a = (0.5 + torch.rand((N, C), generator=g)).to(dev)
    b = (3.0 * (2.0 * torch.rand((N, C), generator=g) - 1.0)).to(dev)
    k = (rnd(3, 3, C, 64) * (9 * C) ** -0.5).to(dev, bf)
    bias = (0.1 * rnd(64)).to(dev)
    kw = {}
    if Cs:
        kw["shortcut"] = ((rnd(N, H, W, Cs) * 0.7).to(dev, bf),
                          (rnd(Cs, 64) * Cs ** -0.5).to(dev, bf), (0.1 * rnd(64)).to(dev))
    if residual:
        kw["residual"] = (rnd(N, H, W, 64) * 0.7).to(dev, bf)
    out, st = gn_silu_conv3x3(x, (a, b), k, bias, **kw)
    ref, ref_st = gn_silu_conv3x3_plain(x, (a, b), k, bias, **kw)
    _close_conv(out, st, ref, ref_st)
    # the same conv with the border padded before the activation is far off
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    y = xp * a[:, None, None] + b[:, None, None]
    y = (y * torch.sigmoid(y)).to(bf).float()
    wrong = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1))
    wrong = wrong.permute(0, 2, 3, 1) + bias
    if Cs:
        xs, sk, sb = kw["shortcut"]
        wrong = wrong + xs.float() @ sk.float() + sb
    if residual:
        wrong = wrong + kw["residual"].float()
    gap = (wrong - ref.float()).abs().max().item()
    assert gap > 10 * 1e-2 * ref.float().abs().max().item(), gap
    assert torch.equal(gn_silu_conv3x3(x.contiguous(), (a, b), k, bias, **kw)[0], out)


def test_gn_silu_conv3x3_kernel_repeats():
    """30 launches of K7 on the same operands are bit-equal, output and
    statistics, at a shape with many tiles per CTA."""
    dev = _card()
    g = torch.Generator().manual_seed(14)
    x = (torch.randn((4, 128, 200, 64), generator=g) * 0.7).to(dev, torch.bfloat16)
    a = (0.5 + torch.rand((4, 64), generator=g)).to(dev)
    b = (torch.randn((4, 64), generator=g)).to(dev)
    k = (torch.randn((3, 3, 64, 64), generator=g) * (9 * 64) ** -0.5).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn((64,), generator=g)).to(dev)
    out, st = gn_silu_conv3x3(x, (a, b), k, bias)
    for _ in range(29):
        o2, s2 = gn_silu_conv3x3(x, (a, b), k, bias)
        assert torch.equal(o2, out) and torch.equal(s2, st)


@pytest.mark.parametrize("emit", [True, False])
@pytest.mark.parametrize("shape", [(2, 256, 256, 128), (3, 32, 32, 512), (3, 64, 64, 256),
                                   (3, 128, 128, 256), (1, 13, 21, 128), (1, 9, 37, 64)])
def test_subpixel_up_conv3x3_kernel(shape, emit):
    """K8 at the serving step's four upsample widths and at ragged shapes."""
    dev = _card()
    _exact_fp32()
    C = shape[-1]
    g = torch.Generator().manual_seed(12)
    x = (torch.randn(shape, generator=g) * 0.7).to(dev, torch.bfloat16)
    k3 = (torch.randn((3, 3, C, C), generator=g) * (9 * C) ** -0.5).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn((C,), generator=g)).to(dev)
    before = subpixel_up_conv3x3.launches
    out, st = subpixel_up_conv3x3(x, k3, bias, emit_stats=emit)
    assert subpixel_up_conv3x3.launches == before + 1
    assert out.shape == (shape[0], 2 * shape[1], 2 * shape[2], C)
    ref, ref_st = subpixel_up_conv3x3_plain(x, k3, bias, emit_stats=emit)
    _close_conv(out, st, ref, ref_st)
    # the middle frame of a clip as a view: the launch takes the batch stride
    clip = torch.stack([x + 1, x, x - 1], dim=1)
    mid = clip[:, 1:2].reshape(shape)
    assert not mid.is_contiguous() or shape[0] == 1
    assert torch.equal(subpixel_up_conv3x3(mid, k3, bias, emit_stats=False)[0], out)


@pytest.mark.parametrize("shape", [
    (1, 5, 7, 64),        # one slice (C = 64) and a tile larger than the image
    (2, 3, 9, 64),
    (1, 36, 16, 128),     # an odd number of pixel tiles (3)
    (2, 40, 48, 256)])
def test_subpixel_up_conv3x3_kernel_edges_and_repeats(shape):
    """K8 where its loops are shortest or its tiles odd in number, held to
    the plain version; two launches give the same bits, statistics too."""
    dev = _card()
    _exact_fp32()
    C = shape[-1]
    g = torch.Generator().manual_seed(13)
    x = (torch.randn(shape, generator=g) * 0.7 + 0.1).to(dev, torch.bfloat16)
    k3 = (torch.randn((3, 3, C, C), generator=g) * (9 * C) ** -0.5).to(dev, torch.bfloat16)
    bias = (0.1 * torch.randn((C,), generator=g)).to(dev)
    out, st = subpixel_up_conv3x3(x, k3, bias)
    ref, ref_st = subpixel_up_conv3x3_plain(x, k3, bias)
    _close_conv(out, st, ref, ref_st)
    again, st2 = subpixel_up_conv3x3(x, k3, bias)
    assert torch.equal(again, out) and torch.equal(st2, st)    # no atomics


def test_fused_conv_kernels_refuse_instead_of_falling_back():
    dev = _card()
    bf = torch.bfloat16
    x = torch.zeros((1, 8, 16, 64), device=dev, dtype=bf)
    k = torch.zeros((3, 3, 64, 64), device=dev, dtype=bf)
    bias = torch.zeros((64,), device=dev)
    gn_silu_conv3x3(x, None, k, bias)                                   # taken
    for bad in (dict(x=x.float()), dict(k=k.float()), dict(bias=bias.to(bf)),
                dict(x=x[:, :, ::2]), dict(x=x.transpose(1, 2)),
                dict(x=x[..., :32].contiguous(), k=k[:, :, :32].contiguous()),    # C = 32
                dict(k=k[..., :32].contiguous(), bias=bias[:32].contiguous())):   # Co = 32
        args = {**dict(x=x, k=k, bias=bias), **bad}
        with pytest.raises((NotImplementedError, ValueError)):
            gn_silu_conv3x3(args["x"], None, args["k"], args["bias"])
    with pytest.raises(NotImplementedError):                            # Cs = 64
        gn_silu_conv3x3(x, None, k, bias, shortcut=(x, k[0, 0], bias))
    with pytest.raises(NotImplementedError):
        gn_silu_conv3x3(x, None, k, bias, residual=x.float())
    subpixel_up_conv3x3(x, k, bias)                                     # taken
    for bad in (dict(x=x.float()), dict(bias=bias.to(bf)), dict(x=x[:, :, ::2]),
                dict(x=x[..., :32].contiguous(), k=k[:, :, :32, :32].contiguous(),
                     bias=bias[:32].contiguous())):                              # C = 32
        args = {**dict(x=x, k=k, bias=bias), **bad}
        with pytest.raises(NotImplementedError):
            subpixel_up_conv3x3(args["x"], args["k"], args["bias"])


@pytest.mark.parametrize("mode,k8,k7", [("1", 1, 4), ("up", 1, 0)])
def test_decoder3d_fused_tail_on_the_card(mode, k8, k7):
    """Decoder3D under FUSED_TAIL on the card (kernels) against the same
    model on the CPU (the plain chain), bf16, middle frames."""
    dev = _card()
    from pgtformer_tpu_torch.config import DDConfig
    from pgtformer_tpu_torch.models.vae import Decoder3D
    dd = DDConfig(z_channels=32, resolution=32, ch=64, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cpu = init_weights(Decoder3D(dd), torch.Generator().manual_seed(13)).to(torch.bfloat16).eval()
    gpu = Decoder3D(dd).to(torch.bfloat16)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev).eval()
    z = torch.randn((6, 16, 16, 32), generator=torch.Generator().manual_seed(14))
    z = (z * 0.5).to(torch.bfloat16)
    try:
        knobs.set_knob("FUSED_TAIL", mode)
        with torch.no_grad():
            ref = cpu(z, middle_only=True).float()
            n8, n7 = subpixel_up_conv3x3.launches, gn_silu_conv3x3.launches
            out = gpu(z.to(dev), middle_only=True).float().cpu()
        assert (subpixel_up_conv3x3.launches, gn_silu_conv3x3.launches) == (n8 + k8, n7 + k7)
    finally:
        knobs.reset()
    assert out.shape == (2, 32, 32, 3)
    err = (out - ref).abs()
    assert err.mean().item() <= 2e-2 * ref.abs().max().item(), err.mean()


def _grad_check(fn, plain, x, blocks, cot):
    """Gradients of x and of every parameter of `blocks` through `fn` and
    through `plain` (each called on x and the blocks' live weights)."""
    res = []
    for f in (fn, plain):
        for b in blocks:
            b.zero_grad(set_to_none=True)
        xx = x.detach().clone().requires_grad_()
        out = f(xx, *(b.live_weights() for b in blocks))
        out.backward(cot)
        res.append((out.detach(), [xx.grad] + [p.grad for b in blocks for p in b.parameters()]))
    (out, got), (ref_out, ref) = res
    assert torch.isfinite(out).all()
    assert (out.float() - ref_out.float()).abs().max() <= 2e-2 * ref_out.float().abs().max()
    for a, b in zip(got, ref):
        assert a is not None and torch.isfinite(a).all()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 1e-3 * b.float().abs().max().item(), err


@pytest.mark.parametrize("kind", ["sw_block", "sw_block_tokens", "sw_block_pair"])
def test_sw_block_function_gradients_on_the_card(kind):
    dev = _card()
    from pgtformer_tpu_torch.ops import sw_block as sw
    shape, shift = (2, 3, 16, 16, 64), (2, 2)
    blocks = [_block_weights(64, 4, 3, seed=40 + i).to(dev) for i in range(2)]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(41)).to(dev, torch.bfloat16)
    counter = getattr(sw, kind)
    if kind == "sw_block_tokens":
        x = window_partition(torch.roll(x, (-2, -2), dims=(2, 3)), (4, 4)).contiguous()
        mask = torch.as_tensor(shifted_window_mask(3, 16, 16, (4, 4), shift), device=dev)
        fn = lambda xx, w, _: sw.sw_block_tokens(xx, w, mask, 16)
        plain = lambda xx, w, _: sw.sw_block_tokens_plain(xx, w, mask, 16)
    elif kind == "sw_block":
        fn = lambda xx, w, _: sw.sw_block(xx, w, shift)
        plain = lambda xx, w, _: sw.sw_block_plain(xx, w, shift)
    else:
        fn = lambda xx, w0, w1: sw.sw_block_pair(xx, w0, w1, shift)
        plain = lambda xx, w0, w1: sw.sw_block_pair_plain(xx, w0, w1, shift)
    if kind != "sw_block_pair":
        blocks, fn, plain = blocks[:1], (lambda xx, w, _f=fn: _f(xx, w, None)), \
            (lambda xx, w, _f=plain: _f(xx, w, None))
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(42)).to(dev, x.dtype)
    before = counter.launches
    _grad_check(fn, plain, x, blocks, cot)
    assert counter.launches == before + 1


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
def test_dense_mha_function_gradients_on_the_card(layout):
    dev = _card()
    from pgtformer_tpu_torch.ops import dense_mha as dm
    g = torch.Generator().manual_seed(43)
    q, k, v = (torch.randn((2, 256, 4, 64), generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    if layout == "bhnd":
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
    plain = dm.dense_mha_plain_bnhd if layout == "bnhd" else dm.dense_mha_plain
    counter = dm.dense_mha_bnhd if layout == "bnhd" else dm.dense_mha_bhnd
    cot = torch.randn(q.shape, generator=g).to(dev, torch.bfloat16)
    res = []
    before = counter.launches
    for f in (lambda a, b, c: dm.dense_mha(a, b, c, scale=0.125, layout=layout),
              lambda a, b, c: plain(a, b, c, 0.125)):
        leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
        out = f(*leaves)
        out.backward(cot)
        res.append((out.detach(), [a.grad for a in leaves]))
    assert counter.launches == before + 1
    (out, got), (ref_out, ref) = res
    assert (out.float() - ref_out.float()).abs().max() <= 1e-2 * ref_out.float().abs().max()
    for a, b in zip(got, ref):
        assert torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max() <= 1e-3 * b.float().abs().max()


def test_stage1_step_bf16_on_the_card_matches_cpu():
    """One small Stage1Trainer step (GAN and LPIPS on, restarts off) in bf16
    on the card against the same step in fp32 on the CPU, from the same
    weights and batch: metrics close, gradients as close as the CPU's own
    bf16 step's (below), every parameter and codebook buffer moved, K1 and
    K5 launched by the forward only."""
    dev = _card()
    import dataclasses
    from pgtformer_tpu_torch.config import DDConfig, VQVAEConfig
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    from pgtformer_tpu_torch.ops import sw_block as sw
    from pgtformer_tpu_torch.ops import vq
    from pgtformer_tpu_torch.train.lpips import make_lpips_fn
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, Stage1Trainer
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cfg = VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64, latent_shape=(16, 16, 32),
                      code_shape=(16, 16, 1), restart_unused_codes=False)
    hp = dataclasses.replace(STAGE_HYPERS["I"], warmup_iter=-1)
    gt = torch.from_numpy(np.random.default_rng(44).integers(0, 256, (2, 3, 32, 32, 3),
                                                              dtype=np.uint8))
    results = {}
    for device, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                          (dev, torch.bfloat16)):
        tr = Stage1Trainer(cfg, hp, lpips_fn=make_lpips_fn(device=device, warn_random=False),
                           device=device, dtype=dtype, disc=VQGANDiscriminator(ndf=16, n_layers=2))
        state = tr.init_state(torch.Generator().manual_seed(45))
        p0 = {n: p.detach().cpu().clone() for n, p in state.g.params.items()}
        c0 = {n: t.detach().cpu().clone() for n, t in state.g.codebook.items()}
        k1, k5 = sw.sw_block.launches, vq.nearest_code.launches
        state, metrics = tr.make_step()(state, gt)
        launches = (sw.sw_block.launches - k1, vq.nearest_code.launches - k5)
        assert all(not torch.equal(p0[n], p.detach().cpu()) for n, p in state.g.params.items())
        assert all(not torch.equal(c0[n], t.cpu()) for n, t in state.g.codebook.items())
        grads = {f"{net}.{n}": p.grad.detach().float().cpu()
                 for net, params in (("g", state.g.params), ("d", state.d.params))
                 for n, p in params.items()}
        results[(str(device), dtype)] = ({k: float(v) for k, v in metrics.items()}, launches,
                                         grads)
    cpu, cpu_launches, cpu_g = results[("cpu", torch.float32)]
    _, cpu16_launches, cpu16_g = results[("cpu", torch.bfloat16)]
    card, card_launches, card_g = results[(str(dev), torch.bfloat16)]
    assert cpu_launches == cpu16_launches == (0, 0)
    assert card_launches[0] > 0 and card_launches[1] == 1
    for k, ref in cpu.items():
        assert np.isfinite(card[k])
        assert abs(card[k] - ref) <= 5e-2 * max(abs(ref), 0.1), (k, card[k], ref)
    # The backward: the card's bf16 gradients (autocast forward, the
    # Functions' recompute, the discriminator's threaded statistics) against
    # the CPU's fp32 ones.  bf16 alone moves this small random model's
    # gradients far (measured on the CPU: 0.51 of the generator's norm, 0.18
    # of the discriminator's; the hinge GAN term and the codes it rounds to
    # differ), so the card's step is held to the CPU's bf16 step (the plain
    # versions under the same autocast): per network, its distance from the
    # fp32 gradients within 1.25 times the CPU bf16 step's plus 0.05 of their
    # norm; per leaf whose norm is at least 1e-2 of the network's largest
    # (smaller ones, such as a bias before a GroupNorm whose exact gradient
    # is 0, hold rounding), its relative distance within 1.5 times the CPU
    # bf16 step's plus 0.1.  A gradient the card's backward lost or got
    # wrong lies at a relative distance of ~1 or more.  Measured on an H100:
    # card 0.513 / 0.166 of the norm, CPU bf16 0.502 / 0.195; worst leaves
    # 0.055 (CPU bf16 0.014) and 0.091 (0.038).
    assert card_g.keys() == cpu_g.keys() == cpu16_g.keys()
    for net in ("g", "d"):
        names = [n for n in cpu_g if n.startswith(net + ".")]
        assert all(torch.isfinite(card_g[n]).all() for n in names)
        dist = lambda a, ns: sum(float((a[n] - cpu_g[n]).square().sum()) for n in ns) ** 0.5
        norm = sum(float(cpu_g[n].square().sum()) for n in names) ** 0.5
        top = max(float(cpu_g[n].norm()) for n in names)
        held = [n for n in names if float(cpu_g[n].norm()) >= 1e-2 * top]
        leaf = {n: (dist(card_g, [n]) / float(cpu_g[n].norm()),
                    dist(cpu16_g, [n]) / float(cpu_g[n].norm())) for n in held}
        worst = max(held, key=lambda n: leaf[n][0] - 1.5 * leaf[n][1])
        print(f"{net}: distance from the fp32 gradients / their norm: card bf16 "
              f"{dist(card_g, names) / norm:.3e}, CPU bf16 {dist(cpu16_g, names) / norm:.3e}; "
              f"card bf16 from CPU bf16 "
              f"{sum(float((card_g[n] - cpu16_g[n]).square().sum()) for n in names) ** 0.5 / norm:.3e}; "
              f"{len(held)} leaves held, worst {worst} card {leaf[worst][0]:.3e} "
              f"CPU bf16 {leaf[worst][1]:.3e}")
        assert dist(card_g, names) <= 1.25 * dist(cpu16_g, names) + 0.05 * norm, net
        for n in held:
            assert leaf[n][0] <= 1.5 * leaf[n][1] + 0.1, (n, leaf[n])


def test_stage1_checkpoint_resume_on_the_card(tmp_path):
    """A small bf16 Stage1Trainer on the card (codebook restarts on, so the
    CUDA generator draws): two steps, a checkpoint, one more step.  A second
    trainer from another seed restores the checkpoint: its modules, EMA,
    Adam state (on the card), schedulers and CUDA generator state equal the
    saved ones bit for bit, and so do its optimizers' learning rates.  Its
    next step equals the uninterrupted step bit for bit: parameters, EMA,
    discriminator and metrics (cuDNN held to its deterministic algorithms
    for the test); this is inside the bf16 step tolerance of
    test_stage1_step_bf16_on_the_card_matches_cpu, 5e-2 of max(|value|,
    0.1) on the metrics, which is checked as well."""
    dev = _card()
    import dataclasses
    from pgtformer_tpu_torch.config import DDConfig, VQVAEConfig
    from pgtformer_tpu_torch.models.vqgan import VQGANDiscriminator
    from pgtformer_tpu_torch.train.stages import STAGE_HYPERS, Stage1Trainer
    from pgtformer_tpu_torch.utils.checkpoint import CheckpointManager
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cfg = VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64, latent_shape=(16, 16, 32),
                      code_shape=(16, 16, 1))
    hp = dataclasses.replace(STAGE_HYPERS["I"], warmup_iter=2, milestones=(3,))
    rng = np.random.default_rng(46)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8))
               for _ in range(3)]

    def trainer(seed):
        tr = Stage1Trainer(cfg, hp, device=dev, dtype=torch.bfloat16,
                           disc=VQGANDiscriminator(ndf=16, n_layers=2))
        return tr, tr.init_state(torch.Generator().manual_seed(seed))

    def tensors(tr, state):
        out = {f"g.{k}": v.detach().clone() for k, v in tr.model.state_dict().items()}
        out.update({f"ema.{k}": v.clone() for k, v in state.g.ema_params.items()})
        out.update({f"d.{k}": v.detach().clone() for k, v in tr.disc.state_dict().items()})
        for name, opt in (("opt_g", tr.opt_g), ("opt_d", tr.opt_d)):
            for i, st in opt.state_dict()["state"].items():
                out.update({f"{name}.{i}.{k}": v.clone() for k, v in st.items()})
        return out

    def lrs(tr):
        return [g["lr"] for opt in (tr.opt_g, tr.opt_d) for g in opt.param_groups]

    cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        tr, state = trainer(47)
        step = tr.make_step()
        for b in batches[:2]:
            state, _ = step(state, b)
        ck = CheckpointManager(str(tmp_path))
        ck.save(state.step, state, tr)
        saved, saved_rng, saved_lr = tensors(tr, state), state.rng.get_state(), lrs(tr)
        state, ref = step(state, batches[2])
        after = tensors(tr, state)

        tr2, state2 = trainer(48)
        ck.restore(state2, tr2)
        assert state2.rng.device.type == "cuda"
        assert torch.equal(state2.rng.get_state(), saved_rng)
        assert all(st["exp_avg"].device.type == "cuda" for st in tr2.opt_g.state.values())
        assert tr2.sched_g.last_epoch == tr2.sched_d.last_epoch == 2
        assert lrs(tr2) == saved_lr
        got = tensors(tr2, state2)
        assert got.keys() == saved.keys()
        for k in saved:
            assert got[k].device == saved[k].device and torch.equal(got[k], saved[k]), k
        state2, m = tr2.make_step()(state2, batches[2])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    got = tensors(tr2, state2)
    diff = max(float((got[k].float() - after[k].float()).abs().max()) for k in after)
    print(f"after the restored step: tensors at most {diff:.3e} from the uninterrupted "
          f"step's; metrics {({k: float(v) for k, v in m.items()})} vs "
          f"{({k: float(v) for k, v in ref.items()})}")
    assert lrs(tr2) == lrs(tr)
    for k, v in ref.items():
        assert abs(float(m[k]) - float(v)) <= 5e-2 * max(abs(float(v)), 0.1), k
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in ref.items()}
    assert got.keys() == after.keys()
    for k in after:
        assert torch.equal(got[k], after[k]), k


def test_eval_cli_on_the_card(tmp_path, monkeypatch, capsys):
    """`eval_cli.main` on the card at a small geometry (bf16 model, seeded
    weights, a seeded 32x32 tree, batch 2 with a tail): every column
    printed and finite, K1 and K6 launched as often as a direct forward
    launches them, once per batch, and no other kernel; then the ArcFace
    IResNet-50 of a seeded state dict on the card against the same
    embedder on the CPU, fp32: max|d| <= 1e-4 * max|e| (chip_smoke.py's
    EVAL_ARC_TOL: summation order only, well below what TF32 gives)."""
    dev = _card()
    import cv2
    from pgtformer_tpu_torch import config, eval_cli
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    from pgtformer_tpu_torch.eval.arcface import IRESNET50_LAYERS, ArcFaceEmbedder, IResNet
    from pgtformer_tpu_torch.models.pgtformer import PGTFormer
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cfg = PGTFormerConfig(vqvae=VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64,
                                            latent_shape=(16, 16, 32), code_shape=(16, 16, 1)),
                          dim_embd=64, n_head=4, n_layers=2, connect_list=("16", "32"),
                          w=1.0, adain=True)
    monkeypatch.setattr(config, "RELEASE_PGTFORMER", cfg)
    rng = np.random.default_rng(0)
    (tmp_path / "GT" / "clip_a").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(tmp_path / "GT" / "clip_a" / f"{i:08d}.png"),
                    rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    model = PGTFormer(cfg, generator=torch.Generator().manual_seed(3))
    torch.save({"params_ema": model.state_dict()}, str(tmp_path / "w.pth"))
    arc_sd = init_weights(IResNet(IRESNET50_LAYERS), torch.Generator().manual_seed(4)).state_dict()
    torch.save(arc_sd, str(tmp_path / "arc.pth"))
    wrappers = (sw_block, sw_block_tokens, sw_block_pair, dense_mha_bhnd, dense_mha_bnhd,
                nearest_code, gn_silu_conv3x3, subpixel_up_conv3x3)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 3, 32, 32, 3)).astype(np.float32)).to(dev)
    gpu = model.to(dev, torch.bfloat16).eval()
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        gpu(x, middle_only=True)
    per_forward = [w.launches - b for w, b in zip(wrappers, before)]
    assert per_forward[0] > 0 and per_forward[4] == 2 and sum(per_forward) == per_forward[0] + 2
    before = [w.launches for w in wrappers]
    rc = eval_cli.main(["--data-root", str(tmp_path), "--weights", str(tmp_path / "w.pth"),
                        "--batch", "2", "--face-metrics", "--arcface-weights",
                        str(tmp_path / "arc.pth")])
    assert rc == 0
    assert [w.launches - b for w, b in zip(wrappers, before)] == [2 * n for n in per_forward]
    lines = dict(line.rsplit(":", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert list(lines) == ["samples", "psnr", "ssim", "lpips(random-vgg)", "deg",
                           "lmd(parser-lm)", "msrl(own-def)", "tlme(parser-lm)"]
    assert int(lines["samples"]) == 3
    assert all(np.isfinite(float(v)) or k == "msrl(own-def)" for k, v in lines.items())
    _exact_fp32()
    img = rng.uniform(0, 1, (96, 96, 3)).astype(np.float32)
    e_gpu = ArcFaceEmbedder(str(tmp_path / "arc.pth"), device=dev)(img)
    e_cpu = ArcFaceEmbedder(str(tmp_path / "arc.pth"), device="cpu")(img)
    assert np.isfinite(e_gpu).all()
    rel = np.abs(e_gpu - e_cpu).max() / np.abs(e_cpu).max()
    assert rel <= 1e-4, rel


def test_restore_video_on_the_card(tmp_path):
    """`restore_video` on the card at a small geometry (bf16, seeded
    weights, a seeded 10-frame 32x32 clip, B=4: 3 steps): the frames passed
    to `frame_callback` bit-equal across `inflight` 1 and 3 and to
    `restore_chunk` over the frames the same reader decodes (the side-stream
    readback changes no byte), and each run launches exactly 3 steps' K1
    and K6 and no other kernel."""
    dev = _card()
    import cv2
    from pgtformer_tpu_torch import pipeline
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cfg = PGTFormerConfig(vqvae=VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64,
                                            latent_shape=(16, 16, 32), code_shape=(16, 16, 1)),
                          dim_embd=64, n_head=4, n_layers=2, connect_list=("16", "32"),
                          w=1.0, adain=True)
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    rng = np.random.default_rng(0)
    for _ in range(10):
        w.write(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    w.release()
    wrappers = (sw_block, sw_block_tokens, sw_block_pair, dense_mha_bhnd, dense_mha_bnhd,
                nearest_code, gn_silu_conv3x3, subpixel_up_conv3x3)
    r = pipeline.VideoRestorer(None, cfg, batch_windows=4, dtype=torch.bfloat16, device=dev,
                               seed=3)
    reader = pipeline._open_reader(src, r.io_backend)
    decoded = list(reader)
    reader.close()
    r.prime(decoded[0])
    before = [w.launches for w in wrappers]
    ref, rest = [], decoded[1:]
    for c in range(3):           # 4 + 4 new frames, then 1 + the end padding
        chunk = rest[4 * c:4 * c + 4]
        n = len(chunk) if c < 2 else len(chunk) + 1
        chunk = chunk + [decoded[-1]] * (4 - len(chunk))
        ref.append(r.restore_chunk(np.stack(chunk))[:n].cpu().numpy())
    per_3_steps = [w.launches - b for w, b in zip(wrappers, before)]
    assert per_3_steps[0] > 0 and per_3_steps[4] == 6 and sum(per_3_steps) == per_3_steps[0] + 6
    ref = np.concatenate(ref)
    for inflight in (1, 3):
        r.inflight = inflight
        frames = []
        before = [w.launches for w in wrappers]
        stats = r.restore_video(src, str(tmp_path / f"out{inflight}.mp4"),
                                frame_callback=lambda i, f: frames.append(f.copy()))
        assert [w.launches - b for w, b in zip(wrappers, before)] == per_3_steps
        assert stats["frames"] == 10 and len(frames) == 10
        assert np.array_equal(np.stack(frames), ref), inflight


def test_sharded_serving_two_ranks_on_one_card(tmp_path):
    """Two gloo ranks spawned on the one card serve the small bf16 model
    (seeded weights, B=4: 2 windows a rank, 3 chunks): rank 0's gathered
    frames bit-equal to one process at batch_windows=2 over the same frames,
    and each rank launches per step the K1 and K6 of that process's step."""
    dev = _card()
    from pgtformer_tpu_torch import parallel
    from pgtformer_tpu_torch import pipeline
    from pgtformer_tpu_torch.config import DDConfig, PGTFormerConfig, VQVAEConfig
    from tests import torch_parallel_workers as W
    dd = DDConfig(z_channels=32, resolution=32, ch=32, ch_mult=(1, 2), depths=(2, 2),
                  num_heads=(4, 4), window_sizes=((4, 4), (4, 4)), attn_resolutions=(16,))
    cfg = PGTFormerConfig(vqvae=VQVAEConfig(ddconfig=dd, embed_dim=32, n_embed=64,
                                            latent_shape=(16, 16, 32), code_shape=(16, 16, 1)),
                          dim_embd=64, n_head=4, n_layers=2, connect_list=("16", "32"),
                          w=1.0, adain=True)
    frames = np.random.default_rng(4).integers(0, 256, (13, 32, 32, 3), dtype=np.uint8)
    kw = dict(state_dict=None, cfg=cfg, frames=frames, B=4, dtype=torch.bfloat16, seed=3)
    ranks = parallel.spawn(W.serve, 2, args=(kw, "cuda"), timeout_s=300,
                           store_dir=str(tmp_path))
    r = pipeline.VideoRestorer(None, cfg, batch_windows=2, dtype=torch.bfloat16, device=dev,
                               seed=3)
    r.prime(frames[0])
    before = sw_block.launches, dense_mha_bnhd.launches
    ref = np.concatenate([r.restore_chunk(frames[1 + 2 * c:3 + 2 * c]).cpu().numpy()
                          for c in range(6)])
    per_rank = ((sw_block.launches - before[0]) // 2, (dense_mha_bnhd.launches - before[1]) // 2)
    assert per_rank[0] > 0 and per_rank[1] == 6
    assert [tuple(x["launches"]) for x in ranks] == [per_rank, per_rank]
    assert np.array_equal(ranks[0]["frames"], ref)
