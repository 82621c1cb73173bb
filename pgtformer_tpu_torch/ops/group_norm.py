"""GroupNorm(32) with an optional SiLU on channels-last bf16 activations.

Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's GroupNorm
and SiLU into the ops around them.  On the card they were ATen's glue: the
statistics as two reductions, about a dozen small ops on ``[N, C]``, a
mixed-dtype ``addcmul`` that does not vectorise, then ``F.silu`` -- x read
three times and written twice, some twenty launches a norm.  The work is a
normalisation pass far below the card's ridge point, so what bounds it is
bytes.  ``csrc/group_norm.cu`` reads x twice and writes y once, in two
launches: a statistics pass that writes per-(CTA, group) partial sums
without atomics, and an apply pass that folds them and streams
``y = bf16(x*a + b)`` (with ``silu``, ``bf16(silu(y))``) with 16-byte
loads; the source says how it fills the card.

:func:`group_norm_silu` launches it for a CUDA tensor and runs
:func:`group_norm_silu_plain`, the port's arithmetic before the kernel
(``sum_sumsq``, ``fused_conv.gn_affine_from_stats``, :func:`affine_round`,
``F.silu``), only for a tensor on the CPU.  Both round where the other
rounds; they differ in the order the fp32 statistics are summed.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pgtformer_tpu_torch.ops import _build
from pgtformer_tpu_torch.ops.fused_conv import gn_affine_from_stats


def affine_round(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x * a + b in fp32 (a, b fp32, broadcast over x), rounded once to
    `dtype` (default x's): one pass over x, no fp32 copy of it (autograd
    takes no out=, so a recorded gradient gets the fp32 result cast)."""
    dtype = dtype or x.dtype
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, a, b)):
        return torch.addcmul(b, x, a).to(dtype)
    return torch.addcmul(b, x, a, out=torch.empty_like(x, dtype=dtype))


def sum_sumsq(x: torch.Tensor, dim) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 sum and sum of squares of x over `dim`, reduced from x's dtype
    (on a card without an fp32 copy of x)."""
    s1 = x.sum(dim, dtype=torch.float32)
    s2 = torch.linalg.vector_norm(x, 2, dim, dtype=torch.float32).square()
    return s1, s2


def group_norm_silu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          silu: bool = False, groups: int = 32,
                          eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(groups, eps) of x [N, H, W, C] (lower precision than its
    fp32 affine) from fp32 statistics, variance E[x^2] - mean^2 as flax,
    scaled in fp32 and rounded once to x's dtype; then, with `silu`,
    ``F.silu`` of the rounded values."""
    stats = torch.stack(sum_sumsq(x, (1, 2)), dim=1)
    a, b = gn_affine_from_stats(stats, weight, bias, x.shape[1] * x.shape[2], groups, eps)
    y = affine_round(x, a[:, None, None], b[:, None, None])
    return F.silu(y) if silu else y


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    if lib.group_norm_silu_launch.argtypes is None:
        lib.group_norm_silu_launch.argtypes = ([_P, ctypes.c_longlong] + [_P] * 4 + [_I] * 3
                                               + [ctypes.c_float, _I, _P])
        lib.group_norm_silu_launch.restype = _I
        lib.group_norm_ctas.argtypes = [_I] * 3
        lib.group_norm_ctas.restype = _I
    return lib


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    silu: bool = False, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm(groups, eps) with an fp32 affine [C] of x [N, H, W, C],
    followed by SiLU when `silu`; the result is x's dtype, contiguous.

    CPU tensor: :func:`group_norm_silu_plain`.  CUDA tensor: the Hopper
    kernel pair (``.launches`` counts calls, two kernels each), for bf16 x
    with C a multiple of 32 up to 2048 and 32 groups; x may have any batch
    stride (a multiple of 8 elements: a middle frame sliced out of a clip);
    x whose pixel rows are not dense is copied to contiguous first.  Raises
    on the rest.  The statistics are summed in a fixed order: two launches
    on the same x give the same bits."""
    if x.dim() != 4 or weight.shape != (x.shape[-1],) or bias.shape != (x.shape[-1],):
        raise ValueError(f"group_norm_silu: x {tuple(x.shape)} weight {tuple(weight.shape)} "
                         f"bias {tuple(bias.shape)}")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, weight, bias, silu, groups, eps)
    if not x.is_cuda:
        raise NotImplementedError(f"group_norm_silu: device {x.device}")
    N, H, W, C = x.shape
    dev = x.device
    if (x.dtype != torch.bfloat16 or groups != 32 or C % 32 or C > 2048 or N > 65535
            or N * H * W == 0):
        raise NotImplementedError(f"group_norm_silu kernel: {x.dtype} x {tuple(x.shape)}, "
                                  f"{groups} groups")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.device != dev or not p.is_contiguous():
            raise NotImplementedError(f"group_norm_silu kernel: {name} must be contiguous "
                                      f"float32 on {dev}, got {p.dtype} on {p.device}")
    if (x.stride(3) != 1 or x.stride(2) != C or x.stride(1) != W * C or x.data_ptr() % 16
            or (N > 1 and x.stride(0) % 8)):
        x = x.contiguous()
    lib = _lib()
    out = torch.empty((N, H, W, C), dtype=torch.bfloat16, device=dev)
    part = torch.empty((N, lib.group_norm_ctas(N, H * W, C), 2, 32), dtype=torch.float32,
                       device=dev)
    code = lib.group_norm_silu_launch(
        x.data_ptr(), x.stride(0), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        part.data_ptr(), N, H * W, C, eps, int(silu),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "group_norm_silu launch")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
