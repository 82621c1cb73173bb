"""The two hand-written CUDA kernels against their plain PyTorch versions on
the card, at the serving step's widths (bf16).

Needs an NVIDIA GPU: every test decides inside itself whether a card exists
and skips with a reason when there is none.  On a machine with a card (no
JAX needed; the repo's conftest imports JAX, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: max|kernel - plain| <= 2e-2 * max|plain| for K1 (the plain
version rounds every intermediate to bf16, the kernel keeps the residual
and LayerNorm in fp32) and <= 1e-2 * max|plain| for K2 (probabilities are
rounded to bf16 before normalization in the kernel, after it in the plain
version).
"""

import numpy as np
import pytest
import torch

from pgtformer_tpu_torch.nn.blocks import EncoderLayer, SWTransformerBlock, init_weights
from pgtformer_tpu_torch.ops.dense_mha import dense_mha, dense_mha_plain
from pgtformer_tpu_torch.ops.sw_block import sw_block, sw_block_plain

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
    q, k = qk[..., :C], qk[..., C:]
    before = dense_mha.launches
    out = dense_mha(q, k, v, num_heads=H, scale=D ** -0.5)
    assert dense_mha.launches == before + 1
    heads = lambda a: a.reshape(B, N, H, D).transpose(1, 2)
    ref = dense_mha_plain(heads(q), heads(k), heads(v), D ** -0.5)
    ref = ref.transpose(1, 2).reshape(B, N, C)
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
    q = torch.zeros((1, 12, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        dense_mha(q, q, q, num_heads=4, scale=0.25)                          # N % 8
    with pytest.raises(NotImplementedError):
        dense_mha(q.float(), q.float(), q.float(), num_heads=4, scale=0.25)


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
