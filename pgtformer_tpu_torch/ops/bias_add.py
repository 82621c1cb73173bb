"""A conv's per-channel bias, and optionally a residual, added in one pass
over a channels-last bf16 activation.

Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's conv bias
into the conv.  On the card ATen runs a biased conv as cuDNN without its
bias and then ``output.add_(bias.reshape(1, C, 1, 1))``, a broadcast that
TensorIterator runs on its strided legacy kernel; a residual add on the
output (``x + h``) is one more pass.  ``csrc/bias_add.cu`` adds both in
place over the conv's output with 16-byte loads, the bias held in shared
memory, each sum rounded where ATen rounds it: bit-equal to that chain.

:func:`bias_add` launches it for a CUDA tensor and runs
:func:`bias_add_plain`, ATen's chain, only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pgtformer_tpu_torch.ops import _build


def bias_add_plain(h: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h + bias (rounded to h's dtype first), then residual + that, each
    sum rounded to h's dtype, in place over h."""
    h.add_(bias.to(h.dtype))
    return h if residual is None else h.add_(residual)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("bias_add")
    if lib.bias_add_launch.argtypes is None:
        lib.bias_add_launch.argtypes = [_P, _L, _P, _I, _P, _L, _I, _I, _I, _P]
        lib.bias_add_launch.restype = _I
    return lib


def _samples_dense(t: torch.Tensor) -> bool:
    """Each sample of t [N, H, W, C] dense (any batch stride, a multiple of
    8 elements), 16-byte aligned."""
    N, H, W, C = t.shape
    return ((C == 1 or t.stride(3) == 1) and (W == 1 or t.stride(2) == C)
            and (H == 1 or t.stride(1) == W * C) and t.data_ptr() % 16 == 0
            and (N == 1 or t.stride(0) % 8 == 0))


def bias_add(h: torch.Tensor, bias: torch.Tensor,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h + bias``, then ``residual + that`` where `residual` is given, in
    place over h [N, H, W, C] (a conv's fresh output); returns the result.

    CPU tensor: :func:`bias_add_plain`.  CUDA tensor: the Hopper kernel
    (``.launches`` counts calls), for bf16 h with H*W*C a multiple of 8, a
    bias [C] in bf16 or fp32 (rounded to bf16 first), C up to 4096, and a
    bf16 residual of h's shape; each sample of h and of the residual may
    lie anywhere (a batch stride that is a multiple of 8 elements), and
    one that is not dense is copied to contiguous first (h then is not
    written).  Raises on the rest."""
    if h.dim() != 4 or bias.shape != (h.shape[-1],) or (
            residual is not None and residual.shape != h.shape):
        raise ValueError(f"bias_add: h {tuple(h.shape)} bias {tuple(bias.shape)} residual "
                         f"{None if residual is None else tuple(residual.shape)}")
    if h.device.type == "cpu":
        return bias_add_plain(h, bias, residual)
    if not h.is_cuda:
        raise NotImplementedError(f"bias_add: device {h.device}")
    N, H, W, C = h.shape
    E = H * W * C
    if h.dtype != torch.bfloat16 or E % 8 or E >= 2 ** 31 or C > 4096 or N > 65535 or N * E == 0:
        raise NotImplementedError(f"bias_add kernel: {h.dtype} h {tuple(h.shape)}")
    if (bias.dtype not in (torch.bfloat16, torch.float32) or bias.device != h.device
            or not bias.is_contiguous()):
        raise NotImplementedError(f"bias_add kernel: bias must be contiguous bf16 or fp32 on "
                                  f"{h.device}, got {bias.dtype} on {bias.device}")
    if residual is not None:
        if residual.dtype != torch.bfloat16 or residual.device != h.device:
            raise NotImplementedError(f"bias_add kernel: residual {residual.dtype} on "
                                      f"{residual.device}")
        if not _samples_dense(residual):
            residual = residual.contiguous()
    if not _samples_dense(h):
        h = h.contiguous()
    code = _lib().bias_add_launch(
        h.data_ptr(), h.stride(0), bias.data_ptr(), int(bias.dtype == torch.float32),
        None if residual is None else residual.data_ptr(),
        0 if residual is None else residual.stride(0), N, E, C,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(code, "bias_add launch")
    bias_add.launches += 1
    return h


bias_add.launches = 0
