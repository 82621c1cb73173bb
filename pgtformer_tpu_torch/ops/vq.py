"""Kernel K5: fused nearest-code lookup of the residual quantizer.

Replaces the TPU kernel ``pgtformer_tpu/ops/pallas_vq.py:
nearest_code_pallas``.  The Hopper kernel is ``csrc/vq_nearest.cu``: a
CTA of 128 threads holds 64 rows against 128-code tiles, each thread an
8 x 8 tile of fp32 FMA products in registers, the x and code k-slices staged
in shared memory by double-buffered ``cp.async``; a running first-minimum
per row stays in registers, so the ``[N, n]`` distance matrix never reaches
device memory.  What bounds it on an H100 is operations at the non-tensor
fp32 peak (2*N*n*D FLOP); PERF.md has the share it reaches.

:func:`nearest_code` launches the kernel for a CUDA tensor and runs
:func:`nearest_code_plain`, the same math in plain PyTorch, only for a
tensor on the CPU.  Both return int64 indices (what tensor indexing takes;
the TPU kernel returns int32).
"""

from __future__ import annotations

import ctypes

import torch

from pgtformer_tpu_torch.ops import _build


def nearest_code_plain(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """argmin_j(|c_j|^2 - 2 x.c_j) in fp32, first minimum on ties.
    x [N, D], codes [n, D] (no padding row) -> int64 [N]."""
    x32 = x.float()
    c32 = codes.float()
    d = (c32 * c32).sum(-1) - 2.0 * (x32 @ c32.T)
    return d.argmin(dim=-1)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.load("vq_nearest")
    fn = lib.vq_nearest_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
        fn.restype = _I
    return lib


def nearest_code(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Nearest code per row: x [N, D], codes [n, D] -> int64 [N].

    CPU tensor: :func:`nearest_code_plain`.  CUDA tensor: the Hopper kernel
    (any N and n; D a multiple of 4); raises on any dtype or layout it does
    not take."""
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[1]:
        raise ValueError(f"nearest_code: x {tuple(x.shape)} codes {tuple(codes.shape)}")
    if x.device.type == "cpu":
        return nearest_code_plain(x, codes)
    if not x.is_cuda:
        raise NotImplementedError(f"nearest_code: device {x.device}")
    N, D = x.shape
    n = codes.shape[0]
    for name, t in (("x", x), ("codes", codes)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise NotImplementedError(
                f"nearest_code kernel: {name} must be contiguous fp32 on x's device "
                f"with 16-byte aligned rows, got {t.dtype} strides {t.stride()}")
    if N == 0 or n == 0 or D % 4:
        raise NotImplementedError(f"nearest_code kernel: N={N} n={n} D={D}")
    csq = torch.empty((n,), dtype=torch.float32, device=x.device)
    out = torch.empty((N,), dtype=torch.int64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib().vq_nearest_launch(x.data_ptr(), codes.data_ptr(), csq.data_ptr(),
                                    out.data_ptr(), N, n, D, stream)
    _build.check(code, "vq_nearest launch")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
