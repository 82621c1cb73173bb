"""The yardstick's arithmetic: peaks, a kernel's operations and bytes, and
the model's operations counted from the reference's shapes.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no
sparsity) at its full 700 W; a card set below that reaches less, so every
share is printed beside the card's power limit.  ``bound_ms``,
``sw_block_flops`` and ``sw_block_bound`` are ``chip_smoke.py``'s, the K6
count is ``chip_smoke.py:phase_mha``'s.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12   # HBM3 bandwidth, H100 SXM


def bound_ms(flops: float, nbytes: float, peak_flops: float = H100_BF16_FLOPS):
    """(least ms the chip could take, "operations" or "bytes")."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sw_block_flops(shape, blocks: int = 1) -> float:
    """One shifted-window block over [B, T, H, W, C] in 4x4 windows: q, k,
    v, projection and the two MLP products at ratio 1 (12 C^2 a token) and
    the window attention (4 T*16 C a token)."""
    B, T, H, W, C = shape
    return blocks * B * T * H * W * (12 * C * C + 4 * T * 16 * C)


def sw_block_bound(shape, blocks: int = 1, mask_bytes: int = 0):
    """Bound of `blocks` blocks in one launch: x read once and written once
    in bf16, each block's bf16 weights, fp32 vectors and fp32 bias table
    read once (K1 derives its shift mask from region labels: no mask
    array)."""
    B, T, H, W, C = shape
    M = B * T * H * W
    N = T * 16
    nbytes = 2 * M * C * 2 + blocks * (6 * C * C * 2 + 10 * C * 4 + 8 * N * N * 4) + mask_bytes
    return bound_ms(sw_block_flops(shape, blocks), nbytes)


def mha_flops(B: int, N: int, H: int, D: int) -> float:
    """Dense attention core: q k^T and p v, 2 N^2 D multiply-adds a head."""
    return 4 * B * H * N * N * D


def mha_bound(B: int, N: int, H: int, D: int):
    """q, k, v read once and the output written once, bf16."""
    return bound_ms(mha_flops(B, N, H, D), 4 * B * N * H * D * 2)


def count_flops(run: Callable[[], None]) -> float:
    """Operations (2 per multiply-add) of the matrix products and convs that
    `run` performs, counted by ``torch.utils.flop_counter`` (run it on meta
    tensors: the shapes are what count)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())


def upsample_excess(shape, cout: int) -> float:
    """Operations that nearest 2x and a conv3x3 count beyond what the
    function needs.  Each output pixel of a parity class sees the same 2x2
    of its input's neighbours (the 3x3 taps summed into four 2x2 phase
    kernels, or one 4x4 transposed conv at stride 2, as the port's default
    ``dilated`` plan runs it): 16 multiply-adds an input pixel and channel
    pair, where the conv at twice the size counts 36."""
    N, H, W, C = shape
    return 2.0 * (36 - 16) * N * H * W * C * cout


def reference_shapes(run: Callable[[], None], layers) -> Tuple[float, Dict[str, List]]:
    """(operations, {"sw_block": [(shape, shift)], "mha": [(B, N, H, D)],
    "upsample": [(shape, channels out)]}) of one call of the reference,
    `run` on meta tensors; `layers` is the reference's ``layers`` module,
    whose blocks report their shapes.  The operations are the work the
    function needs: the upsamples counted as their phase convs."""
    seen: Dict[str, List] = {"sw_block": [], "mha": [], "upsample": []}
    layers.record_sw_block = lambda shape, shift: seen["sw_block"].append((shape, shift))
    layers.record_mha = lambda shape: seen["mha"].append(shape)
    layers.record_upsample = lambda shape, cout: seen["upsample"].append((shape, cout))
    try:
        flops = count_flops(run)
    finally:
        layers.record_sw_block = None
        layers.record_mha = None
        layers.record_upsample = None
    return flops - sum(upsample_excess(*u) for u in seen["upsample"]), seen
