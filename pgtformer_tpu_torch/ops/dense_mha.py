"""Kernel K2: dense multi-head attention of the code transformer.

Replaces the TPU kernel ``pgtformer_tpu/ops/flash_attn.py:
_dense_mha_pallas`` (via ``dense_mha(layout="bhnd")``) and covers the
heads-minor layout of ``_dense_mha_pallas_bnhd``: the Hopper kernel
(``csrc/dense_mha.cu``) reads q/k/v straight from the packed ``[B, N, C]``
projections through strides and writes the packed ``[B, N, C]`` output.
The TPU kernel keeps a head's whole K/V in VMEM; a Hopper SM cannot, so
the kernel runs an online softmax over 64-key tiles.  At N=3072 it is
compute-bound (~N/2 FLOP per byte).

:func:`dense_mha` launches the kernel for CUDA tensors and runs
:func:`dense_mha_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from pgtformer_tpu_torch.ops import _build


def dense_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q*scale k^T) v on [B, H, N, D]: fp32 scores and softmax,
    probabilities in q's dtype, fp32 PV (the JAX package's _dense_mha_ref)."""
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("dense_mha")
    fn = lib.dense_mha_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 4 + [_L] * 8 + [ctypes.c_float, _P]
        fn.restype = _I
    return lib


def dense_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, scale: float) -> torch.Tensor:
    """Self-attention core on packed projections q, k, v [B, N, C] (any
    batch/row strides, unit channel stride; head h at columns h*D).
    Returns the packed [B, N, C] output.

    CPU tensors: :func:`dense_mha_plain`.  CUDA tensors: the Hopper kernel;
    raises on any dtype, shape or layout it does not take."""
    B, N, C = q.shape
    D = C // num_heads
    if q.device.type == "cpu":
        heads = lambda a: a.reshape(B, a.shape[1], num_heads, D).transpose(1, 2)
        out = dense_mha_plain(heads(q), heads(k), heads(v), scale)
        return out.transpose(1, 2).reshape(B, N, C)
    if not q.is_cuda:
        raise NotImplementedError(f"dense_mha: device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (B, N, C)
                or t.device != q.device or t.stride(2) != 1
                or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16):
            raise NotImplementedError(
                f"dense_mha kernel: {name} must be bf16 [B,N,C] with unit "
                f"channel stride and 16-byte aligned rows, got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()}")
    if C % num_heads or D not in (16, 32, 64) or N % 8:
        raise NotImplementedError(
            f"dense_mha kernel: C={C} heads={num_heads} N={N}")
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().dense_mha_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, num_heads, N, D,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1),
        float(scale), stream)
    _build.check(code, "dense_mha launch")
    dense_mha.launches += 1
    return out


dense_mha.launches = 0
