"""Kernels K2 and K6: dense multi-head attention of the code transformer.

Two entry points over the one strided Hopper kernel ``csrc/dense_mha.cu``:

* :func:`dense_mha_bhnd` (K2) replaces the TPU kernel ``pgtformer_tpu/ops/
  flash_attn.py:_dense_mha_pallas`` (``dense_mha(layout="bhnd")``): q, k, v
  and the output are ``[B, H, N, D]``.
* :func:`dense_mha_bnhd` (K6) replaces ``_dense_mha_pallas_bnhd``
  (``layout="bnhd"``): q, k, v are ``[B, N, H, D]`` views of the packed
  projections, and the output is written packed ``[B, N, H*D]`` and
  returned as its free ``[B, N, H, D]`` view.

:func:`dense_mha` takes the JAX package's ``layout`` argument and
dispatches.  Either way the kernel reads its operands in place through 4-D
TMA tensor maps whose geometry (:func:`tma_geometry`: dims, byte strides,
box, swizzle) comes from each tensor's own strides, so no head transpose is
materialized.  The TPU kernels keep a head's whole K/V in VMEM; a Hopper SM
cannot, so the kernel streams 128-key tiles through a TMA ring and runs an
online softmax on ``wgmma`` scores kept in registers, with P fed back from
registers into the P.V product (see the note at the top of the source).  At
N=3072 it is bound by operations (~N/2 FLOP per byte).

Each entry point launches the kernel for CUDA tensors and runs its plain
version (:func:`dense_mha_plain`, :func:`dense_mha_plain_bnhd`) only for
tensors on the CPU; each has its own launch counter.

Operands are bf16 or fp32, and the output takes q's dtype, as in the TPU
kernels: under fp32 q, k and v are rounded to bf16 and the normalized fp32
output is stored unrounded.  The plain versions have the same fp32 form;
:func:`dense_mha_ref` (JAX's ``_dense_mha_ref``, the XLA attention) computes
in q's dtype throughout and equals the plain version under bf16.

When a gradient is recorded and q, k or v requires one, :func:`dense_mha`
runs the entry point inside a ``torch.autograd.Function`` (the counterpart
of the JAX package's ``custom_vjp``, ``ops/flash_attn.py:108-119``): the
forward launches the kernel, the backward recomputes the layout's
:func:`dense_mha_ref` with autograd.  Neither package has a backward kernel; the backward
runs on cuBLAS and ATen.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from pgtformer_tpu_torch.ops import _build
from pgtformer_tpu_torch.ops.autograd import KernelFunction


def _attention(q, k, v, scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    s = torch.einsum("bhqd,bhkd->bhqk", (q * scale).float(), k.float())
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(out_dtype)


def dense_mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """softmax(q*scale k^T) v on [B, H, N, D]: fp32 scores and softmax,
    probabilities and output in q's dtype, fp32 PV (the JAX package's
    _dense_mha_ref, which its custom VJP differentiates)."""
    return _attention(q, k, v, scale, q.dtype)


def dense_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel on [B, H, N, D]:
    :func:`dense_mha_ref` under bf16; under fp32 the kernel's fp32 form,
    q, k and v rounded to bf16, the bf16 attention with an fp32 output."""
    if q.dtype == torch.float32:
        bf = torch.bfloat16
        return _attention(q.to(bf), k.to(bf), v.to(bf), scale, torch.float32)
    return dense_mha_ref(q, k, v, scale)


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(1, 2)


def dense_mha_plain_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """:func:`dense_mha_plain` on heads-minor [B, N, H, D] operands."""
    return _t(dense_mha_plain(_t(q), _t(k), _t(v), scale))


def dense_mha_ref_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """:func:`dense_mha_ref` on heads-minor [B, N, H, D] operands."""
    return _t(dense_mha_ref(_t(q), _t(k), _t(v), scale))


BOX_ROWS = 128    # rows of one TMA box: the kernel's query tile and key tile


class TmaGeometry(NamedTuple):
    """One operand's 4-D TMA tensor map, innermost dimension first."""
    dims: Tuple[int, int, int, int]      # (D, rows N, heads H, batch B)
    strides: Tuple[int, int, int]        # bytes between rows, heads, batches
    box: Tuple[int, int, int, int]       # (D, BOX_ROWS, 1, 1)
    swizzle: int                         # bytes: one row of D (32, 64 or 128)

    def flat(self) -> Tuple[int, ...]:
        return (*self.dims, *self.strides, *self.box, self.swizzle)


def tma_geometry(t: torch.Tensor, layout: str) -> TmaGeometry:
    """The TMA geometry of one operand ([B, H, N, D] for layout="bhnd",
    [B, N, H, D] for "bnhd"), read from the tensor's own strides.  Raises
    NotImplementedError on what TMA and the kernel do not take: a dtype
    other than bf16, D not in (16, 32, 64), a stride along D other than 1,
    another stride that is not a multiple of 16 bytes, a base address that is
    not 16-byte aligned."""
    if t.dim() != 4:
        raise ValueError(f"dense_mha takes 4-D operands, got {tuple(t.shape)}")
    if layout == "bhnd":
        (B, H, N, D), (sb, sh, sn, sd) = t.shape, t.stride()
    elif layout == "bnhd":
        (B, N, H, D), (sb, sn, sh, sd) = t.shape, t.stride()
    else:
        raise ValueError(f"layout {layout!r} (choices: bhnd, bnhd)")
    e = t.element_size()
    strides = (sn * e, sh * e, sb * e)
    if (t.dtype != torch.bfloat16 or D not in (16, 32, 64) or sd != 1
            or any(s % 16 for s in strides) or t.data_ptr() % 16):
        raise NotImplementedError(
            f"dense_mha kernel: operands must be bf16 with D in (16, 32, 64), unit "
            f"stride along D, rows, heads and batches 16-byte aligned; got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()} at {t.data_ptr()}")
    return TmaGeometry((D, N, H, B), strides, (D, BOX_ROWS, 1, 1), 2 * D)


_P = ctypes.c_void_p
_LL = ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    lib = _build.load("dense_mha")
    fn = lib.dense_mha_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_LL, _LL, ctypes.c_int, ctypes.c_float, _P]
        fn.restype = ctypes.c_int
    return lib


def _launch(q, k, v, out, layout: str, out_strides, scale: float) -> None:
    """Check what the kernel needs and launch it.  `out_strides` are the
    output's (batch, head, row) strides in elements; an fp32 `out` takes
    the fp32 store of the bf16 operands."""
    geom = [tma_geometry(t, layout) for t in (q, k, v)]
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device:
            raise NotImplementedError(
                f"dense_mha kernel: {name} {tuple(t.shape)} on {t.device}, "
                f"q {tuple(q.shape)} on {q.device}")
    D, N = geom[0].dims[:2]
    if N % 8:
        raise NotImplementedError(f"dense_mha kernel: N={N} D={D}")
    table = (ctypes.c_longlong * 36)(*(x for g in geom for x in g.flat()))
    ostr = (ctypes.c_longlong * 3)(*out_strides)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.dense_mha_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                table, ostr, int(out.dtype == torch.float32), float(scale),
                                stream)
    _build.check(code, "dense_mha launch")


def _on_cpu(q: torch.Tensor) -> bool:
    if q.dim() != 4:
        raise ValueError(f"dense_mha takes 4-D operands, got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return True
    if not q.is_cuda:
        raise NotImplementedError(f"dense_mha: device {q.device}")
    return False


def _operands(q, k, v):
    """q, k, v as the kernel reads them: bf16 as given; fp32 rounded to
    bf16 (the output is then fp32).  Any other dtype is left for
    :func:`tma_geometry` to refuse."""
    if q.dtype == torch.float32 and k.dtype == v.dtype == torch.float32:
        return tuple(t.to(torch.bfloat16) for t in (q, k, v))
    return q, k, v


def dense_mha_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Attention core on q, k, v [B, H, N, D], bf16 or fp32 (any
    batch/head/row strides, unit stride along D) -> contiguous [B, H, N, D]
    in q's dtype.

    CPU tensors: :func:`dense_mha_plain`.  CUDA tensors: the Hopper kernel;
    raises on any dtype, shape or layout it does not take."""
    if _on_cpu(q):
        return dense_mha_plain(q, k, v, scale)
    B, H, N, D = q.shape
    out = torch.empty((B, H, N, D), dtype=q.dtype, device=q.device)
    _launch(*_operands(q, k, v), out, "bhnd", (out.stride(0), out.stride(1), out.stride(2)),
            scale)
    dense_mha_bhnd.launches += 1
    return out


dense_mha_bhnd.launches = 0


def dense_mha_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """Attention core on heads-minor q, k, v [B, N, H, D], bf16 or fp32
    (views of packed projections: any batch/row/head strides, unit stride
    along D) -> [B, N, H, D] in q's dtype, the view of a packed contiguous
    [B, N, H*D] buffer.

    CPU tensors: :func:`dense_mha_plain_bnhd`.  CUDA tensors: the Hopper
    kernel; raises on any dtype, shape or layout it does not take."""
    if _on_cpu(q):
        return dense_mha_plain_bnhd(q, k, v, scale)
    B, N, H, D = q.shape
    out = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    _launch(*_operands(q, k, v), out, "bnhd", (out.stride(0), out.stride(2), out.stride(1)),
            scale)
    dense_mha_bnhd.launches += 1
    return out


dense_mha_bnhd.launches = 0


def dense_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
              layout: str = "bhnd") -> torch.Tensor:
    """softmax(q k^T * scale) v with the JAX package's signature:
    layout="bhnd" takes and returns [B, H, N, D] (:func:`dense_mha_bhnd`),
    layout="bnhd" takes and returns [B, N, H, D] (:func:`dense_mha_bnhd`).
    A recorded gradient goes through the autograd Function: the entry
    point's forward, the backward of :func:`dense_mha_ref` (or
    :func:`dense_mha_ref_bnhd`) recomputed."""
    if layout not in ("bhnd", "bnhd"):
        raise ValueError(f"layout {layout!r} (choices: bhnd, bnhd)")
    kernel = dense_mha_bnhd if layout == "bnhd" else dense_mha_bhnd
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        ref = dense_mha_ref_bnhd if layout == "bnhd" else dense_mha_ref
        return KernelFunction.apply(lambda a, b, c: kernel(a, b, c, scale),
                                    lambda a, b, c: ref(a, b, c, scale), q, k, v)
    return kernel(q, k, v, scale)
