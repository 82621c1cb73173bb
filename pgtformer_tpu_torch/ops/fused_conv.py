"""Kernels K7 and K8: the fused GroupNorm + SiLU + conv3x3 chain of the
decoder's per-frame high-resolution tail.

Replaces the TPU kernels ``pgtformer_tpu/ops/pallas_conv.py:gn_silu_conv3x3``
and ``subpixel_up_conv3x3``.  The Hopper kernels are implicit GEMMs on the
tensor cores over pixel tiles with a one-pixel halo: K7 in
``csrc/fused_conv.cu`` (wmma), K8 in ``csrc/subpixel_up.cu`` (TMA weight
ring feeding wgmma).

The chain removes the stand-alone passes around the tail's convs:

* GroupNorm becomes a per-(sample, channel) affine ``y = x*a + b`` whose
  statistics the PREVIOUS kernel of the chain emitted: each kernel also
  returns per-channel ``(sum, sum of squares)`` of its own bf16 output, so no
  statistics pass runs (:func:`gn_affine_from_stats` folds them, plain
  PyTorch on ``[N, C]``);
* SiLU runs in registers between the affine and the conv's taps;
* the nearest-2x upsample + conv3x3 runs as four 2x2 phase convs on the
  source grid with pre-summed kernels (:func:`phase_kernels_2x2`) and writes
  the interleaved ``2H x 2W`` result directly.

:func:`gn_silu_conv3x3` and :func:`subpixel_up_conv3x3` launch the kernels
for a CUDA tensor and run their plain versions (``*_plain``: the same
arithmetic with the same roundings in plain PyTorch) only for a tensor on
the CPU.  Inference only: neither has a backward.  The plain versions
multiply in fp32 (products of bf16 values are exact there); on a card,
compare with ``torch.backends.cudnn.allow_tf32 = False``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pgtformer_tpu_torch.ops import _build

Shortcut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Per-(sample, channel) [sum, sum of squares] of x [N, H, W, C] in
    fp32, shaped [N, 2, C]: the format the kernels emit."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))], dim=1)


def gn_affine_from_stats(stats: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         hw: int, groups: int = 32,
                         eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold GroupNorm(groups, eps) and its affine into per-(sample, channel)
    scale and offset [N, C] (fp32) from per-channel stats [N, 2, C] over
    `hw` pixels; the variance is E[x^2] - mean^2."""
    N, _, C = stats.shape
    cg = C // groups
    cnt = hw * cg
    s1 = stats[:, 0].reshape(N, groups, cg).sum(-1)
    s2 = stats[:, 1].reshape(N, groups, cg).sum(-1)
    mu = s1 / cnt
    var = s2 / cnt - mu * mu
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(cg, dim=1)
    inv_c = inv.repeat_interleave(cg, dim=1)
    a = inv_c * gamma.float()[None]
    b = beta.float()[None] - mu_c * a
    return a, b


def phase_kernels_2x2(k3: torch.Tensor) -> torch.Tensor:
    """Pre-sum a 3x3 kernel [3, 3, C, Co] into the four parity-class 2x2
    kernels of nearest-up2x + conv3x3: fp32 [2(a), 2(b), 2(u), 2(v), C, Co].
    Output pixel (2i+a, 2j+b) taps source rows {i-1: k[0], i: k[1]+k[2]} for
    a=0 and {i: k[0]+k[1], i+1: k[2]} for a=1, and columns alike."""
    k3 = k3.float()

    def pair(k, a, axis):
        s0, s1, s2 = k.unbind(axis)
        return torch.stack([s0, s1 + s2] if a == 0 else [s0 + s1, s2], dim=axis)

    return torch.stack([torch.stack([pair(pair(k3, a, 0), b, 1) for b in (0, 1)])
                        for a in (0, 1)])


def conv_kernel_hwio(weight: torch.Tensor) -> torch.Tensor:
    """An OIHW conv weight as the kernels' [kh, kw, C, Co] bf16 operand."""
    return weight.detach().permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()


def _silu_affine(x: torch.Tensor, ab) -> torch.Tensor:
    xb = x.to(torch.bfloat16)
    if ab is None:
        return xb
    a, b = ab
    y = xb.float() * a.float()[:, None, None] + b.float()[:, None, None]
    return (y * torch.sigmoid(y)).to(torch.bfloat16)


def _conv_f32(y: torch.Tensor, k: torch.Tensor, padding) -> torch.Tensor:
    """conv of bf16 values [N, H, W, C] with a bf16 kernel [kh, kw, C, Co],
    multiplied and summed in fp32 -> fp32 [N, H', W', Co]."""
    w = k.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    return F.conv2d(y.float().permute(0, 3, 1, 2), w, padding=padding).permute(0, 2, 3, 1)


def gn_silu_conv3x3_plain(x: torch.Tensor, ab, k: torch.Tensor, bias: torch.Tensor, *,
                          shortcut: Optional[Shortcut] = None,
                          residual: Optional[torch.Tensor] = None, emit_stats: bool = True):
    """Plain version of :func:`gn_silu_conv3x3`, rounding where the kernel
    rounds: x to bf16; affine and SiLU in fp32, then bf16; zero padding after
    the activation; taps, bias, shortcut product and residual summed in fp32;
    one rounding to bf16; stats of the rounded values in fp32."""
    acc = _conv_f32(_silu_affine(x, ab), k, 1) + bias.float()
    if shortcut is not None:
        xs, sk, sb = shortcut
        acc = acc + xs.to(torch.bfloat16).float() @ sk.to(torch.bfloat16).float() + sb.float()
    if residual is not None:
        acc = acc + residual.to(torch.bfloat16).float()
    out = acc.to(torch.bfloat16)
    return out, (channel_stats(out) if emit_stats else None)


def _phase_kernels_bf16(k: torch.Tensor) -> torch.Tensor:
    """[3,3,C,C] -> the bf16 phase kernels (summed in fp32, then rounded);
    [2,2,2,2,C,C] is taken as already derived."""
    if k.dim() == 6:
        return k
    return phase_kernels_2x2(k).to(torch.bfloat16)


def subpixel_up_conv3x3_plain(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor, *,
                              emit_stats: bool = True):
    """Plain version of :func:`subpixel_up_conv3x3`: four 2x2 convs of the
    zero-padded bf16 input with the rounded phase kernels in fp32, bias in
    fp32, one rounding, phases interleaved."""
    N, H, W, C = x.shape
    k2 = _phase_kernels_bf16(k3)
    xp = F.pad(x.to(torch.bfloat16), (0, 0, 1, 1, 1, 1))
    rows = []
    for a in (0, 1):
        cols = []
        for b in (0, 1):
            o = _conv_f32(xp[:, a:a + H + 1, b:b + W + 1], k2[a, b], 0) + bias.float()
            cols.append(o.to(torch.bfloat16))
        rows.append(torch.stack(cols, dim=3))                  # [N, H, W, 2, C]
    out = torch.stack(rows, dim=2).reshape(N, 2 * H, 2 * W, C)  # [N, H, 2, W, 2, C]
    return out, (channel_stats(out) if emit_stats else None)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_conv")
    if lib.gn_silu_conv3x3_launch.argtypes is None:
        lib.gn_silu_conv3x3_launch.argtypes = [_P, _L] + [_P] * 10 + [_I] * 6 + [_P]
        lib.gn_silu_conv3x3_launch.restype = _I
        lib.gn_silu_conv3x3_tiles.argtypes = [_I] * 5
        lib.gn_silu_conv3x3_tiles.restype = _I
    return lib


def _up_lib() -> ctypes.CDLL:
    lib = _build.load("subpixel_up")
    if lib.subpixel_up_conv3x3_launch.argtypes is None:
        lib.subpixel_up_conv3x3_launch.argtypes = [_P, _L] + [_P] * 4 + [_I] * 4 + [_P]
        lib.subpixel_up_conv3x3_launch.restype = _I
        lib.subpixel_up_conv3x3_tiles.argtypes = [_I] * 2
        lib.subpixel_up_conv3x3_tiles.restype = _I
    return lib


def _on_cpu(fn: str, x: torch.Tensor) -> bool:
    if x.dim() != 4:
        raise ValueError(f"{fn} takes x [N, H, W, C], got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise NotImplementedError(f"{fn}: device {x.device}")
    return False


def _check_image(fn: str, name: str, t: torch.Tensor, shape, dev, batch_stride: bool = False):
    """bf16 [N, H, W, C] on `dev`, dense rows and pixels; the batch stride may
    differ from H*W*C only where the kernel takes one."""
    N, H, W, C = shape
    dense = (t.stride(3) == 1 and t.stride(2) == C and t.stride(1) == W * C)
    if (t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape) or t.device != dev
            or not dense or t.data_ptr() % 16 or t.stride(0) % 8
            or (not batch_stride and N > 1 and t.stride(0) != H * W * C)):
        raise NotImplementedError(
            f"{fn} kernel: {name} must be bf16 {tuple(shape)} on {dev} with dense rows, "
            f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _check_param(fn: str, name: str, t: torch.Tensor, shape, dtype, dev):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise NotImplementedError(
            f"{fn} kernel: {name} must be contiguous {dtype} {tuple(shape)} on {dev}, "
            f"got {t.dtype} {tuple(t.shape)} strides {t.stride()}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gn_silu_conv3x3(x: torch.Tensor, ab, k: torch.Tensor, bias: torch.Tensor, *,
                    shortcut: Optional[Shortcut] = None,
                    residual: Optional[torch.Tensor] = None, emit_stats: bool = True):
    """One fused pass: ``conv3x3(silu(x*a + b)) [+ xs @ sk + sb] [+ residual]``.

    x [N, H, W, C] bf16; ab = (a, b), per-(sample, channel) fp32 [N, C]
    (None: a plain conv without activation); k [3, 3, C, Co] bf16; bias [Co]
    fp32; shortcut = (xs [N, H, W, Cs] bf16, sk [Cs, Co] bf16, sb [Co] fp32),
    the 1x1 shortcut conv; residual [N, H, W, Co] bf16.  Returns (y
    [N, H, W, Co] bf16, stats [N, 2, Co] fp32 of y or None).

    CPU tensor: :func:`gn_silu_conv3x3_plain`.  CUDA tensor: the Hopper
    kernel, for (C, Co, Cs) in {(128, 64, none), (64, 64, none),
    (64, 64, 128)}, any N, H, W; x may have any batch stride (a multiple of
    8), every other operand is contiguous; raises on the rest.  The stats are
    summed from per-tile partial sums, so they repeat from run to run."""
    fn = "gn_silu_conv3x3"
    if _on_cpu(fn, x):
        return gn_silu_conv3x3_plain(x, ab, k, bias, shortcut=shortcut, residual=residual,
                                     emit_stats=emit_stats)
    N, H, W, C = x.shape
    dev = x.device
    if k.dim() != 4 or tuple(k.shape[:3]) != (3, 3, C):
        raise ValueError(f"{fn}: x {tuple(x.shape)} k {tuple(k.shape)}")
    Co = k.shape[3]
    Cs = shortcut[0].shape[-1] if shortcut is not None else 0
    if (C, Co, Cs) not in ((128, 64, 0), (64, 64, 0), (64, 64, 128)) or N * H * W == 0:
        raise NotImplementedError(f"{fn} kernel: C={C} Co={Co} Cs={Cs} x {tuple(x.shape)}")
    _check_image(fn, "x", x, (N, H, W, C), dev, batch_stride=True)
    _check_param(fn, "k", k, (3, 3, C, Co), torch.bfloat16, dev)
    _check_param(fn, "bias", bias, (Co,), torch.float32, dev)
    a = b = xs = sk = sb = None
    if ab is not None:
        a, b = ab
        _check_param(fn, "a", a, (N, C), torch.float32, dev)
        _check_param(fn, "b", b, (N, C), torch.float32, dev)
    if shortcut is not None:
        xs, sk, sb = shortcut
        _check_image(fn, "shortcut input", xs, (N, H, W, Cs), dev)
        _check_param(fn, "shortcut kernel", sk, (Cs, Co), torch.bfloat16, dev)
        _check_param(fn, "shortcut bias", sb, (Co,), torch.float32, dev)
    if residual is not None:
        _check_image(fn, "residual", residual, (N, H, W, Co), dev)
    lib = _lib()
    out = torch.empty((N, H, W, Co), dtype=torch.bfloat16, device=dev)
    part = None
    if emit_stats:
        part = torch.empty((N, lib.gn_silu_conv3x3_tiles(H, W, C, Co, Cs), 2, Co),
                           dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.gn_silu_conv3x3_launch(
        x.data_ptr(), x.stride(0), _ptr(a), _ptr(b), k.data_ptr(), bias.data_ptr(), _ptr(xs),
        _ptr(sk), _ptr(sb), _ptr(residual), out.data_ptr(), _ptr(part), N, H, W, C, Co, Cs,
        stream)
    _build.check(code, f"{fn} launch")
    gn_silu_conv3x3.launches += 1
    return out, (part.sum(dim=1) if emit_stats else None)


gn_silu_conv3x3.launches = 0


def subpixel_up_conv3x3(x: torch.Tensor, k3: torch.Tensor, bias: torch.Tensor, *,
                        emit_stats: bool = True):
    """``conv3x3(nearest_up2(x)) + bias`` with the interleaved write:
    x [N, H, W, C] bf16 -> (y [N, 2H, 2W, C] bf16, stats [N, 2, C] fp32 of y
    or None).  `k3` is the stock [3, 3, C, C] kernel, or the bf16 phase
    kernels [2, 2, 2, 2, C, C] derived from it once
    (``phase_kernels_2x2(k3).to(bfloat16)``); bias [C] fp32.

    CPU tensor: :func:`subpixel_up_conv3x3_plain`.  CUDA tensor: the Hopper
    kernel, for C a multiple of 64, any N, H, W; x may have any batch stride
    (a multiple of 8); raises on the rest."""
    fn = "subpixel_up_conv3x3"
    if _on_cpu(fn, x):
        return subpixel_up_conv3x3_plain(x, k3, bias, emit_stats=emit_stats)
    N, H, W, C = x.shape
    dev = x.device
    if tuple(k3.shape) not in ((3, 3, C, C), (2, 2, 2, 2, C, C)):
        raise ValueError(f"{fn}: x {tuple(x.shape)} kernel {tuple(k3.shape)}")
    if C % 64 or N * H * W == 0:
        raise NotImplementedError(f"{fn} kernel: x {tuple(x.shape)}")
    _check_image(fn, "x", x, (N, H, W, C), dev, batch_stride=True)
    k2 = _phase_kernels_bf16(k3)
    _check_param(fn, "phase kernels", k2, (2, 2, 2, 2, C, C), torch.bfloat16, dev)
    _check_param(fn, "bias", bias, (C,), torch.float32, dev)
    lib = _up_lib()
    out = torch.empty((N, 2 * H, 2 * W, C), dtype=torch.bfloat16, device=dev)
    part = None
    if emit_stats:
        part = torch.empty((N, lib.subpixel_up_conv3x3_tiles(H, W), 2, C),
                           dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.subpixel_up_conv3x3_launch(x.data_ptr(), x.stride(0), k2.data_ptr(),
                                          bias.data_ptr(), out.data_ptr(), _ptr(part), N, H, W,
                                          C, stream)
    _build.check(code, f"{fn} launch")
    subpixel_up_conv3x3.launches += 1
    return out, (part.sum(dim=1) if emit_stats else None)


subpixel_up_conv3x3.launches = 0


@dataclass
class ResBlockKernelWeights:
    """A ResnetBlock's weights in the kernels' layouts: norm affines and
    biases fp32, conv kernels [3, 3, C, Co] bf16, the 1x1 shortcut [C, Co]
    bf16 (None on an identity shortcut)."""
    norm1_weight: torch.Tensor
    norm1_bias: torch.Tensor
    conv1_kernel: torch.Tensor
    conv1_bias: torch.Tensor
    norm2_weight: torch.Tensor
    norm2_bias: torch.Tensor
    conv2_kernel: torch.Tensor
    conv2_bias: torch.Tensor
    shortcut_kernel: Optional[torch.Tensor] = None
    shortcut_bias: Optional[torch.Tensor] = None


def fused_resblock(x: torch.Tensor, stats: torch.Tensor, w: ResBlockKernelWeights,
                   groups: int = 32):
    """GroupNorm -> SiLU -> conv3x3, twice, plus the shortcut, as two
    :func:`gn_silu_conv3x3` passes; `stats` are x's.  Returns (y, y's stats)."""
    hw = x.shape[1] * x.shape[2]
    ab1 = gn_affine_from_stats(stats, w.norm1_weight, w.norm1_bias, hw, groups)
    mid, st = gn_silu_conv3x3(x, ab1, w.conv1_kernel, w.conv1_bias)
    ab2 = gn_affine_from_stats(st, w.norm2_weight, w.norm2_bias, hw, groups)
    if w.shortcut_kernel is not None:
        return gn_silu_conv3x3(mid, ab2, w.conv2_kernel, w.conv2_bias,
                               shortcut=(x, w.shortcut_kernel, w.shortcut_bias))
    return gn_silu_conv3x3(mid, ab2, w.conv2_kernel, w.conv2_bias, residual=x)


def fused_decoder_tail(h: torch.Tensor, up: Tuple[torch.Tensor, torch.Tensor],
                       block0: ResBlockKernelWeights, block1: ResBlockKernelWeights,
                       norm_out: Tuple[torch.Tensor, torch.Tensor],
                       groups: int = 32) -> torch.Tensor:
    """The per-frame decoder tail as a chain of fused kernels:

        u  = subpixel_up(h)              (the level-1 upsample)
        b0 = resblock(u)    128 -> 64    (1x1 shortcut)
        b1 = resblock(b0)   64  -> 64    (identity shortcut)
        return silu(groupnorm(b1))       (norm_out folded from b1's stats)

    h [N, H, W, C] bf16; `up` = (phase kernels or 3x3 kernel, bias);
    `norm_out` = (weight, bias).  The last affine and SiLU run in fp32 as
    plain PyTorch; the result [N, 2H, 2W, Co] (h's dtype) is ready for
    conv_out.  Five kernel launches on a CUDA tensor."""
    u, st = subpixel_up_conv3x3(h, up[0], up[1])
    b0, st0 = fused_resblock(u, st, block0, groups)
    b1, st1 = fused_resblock(b0, st0, block1, groups)
    a, b = gn_affine_from_stats(st1, norm_out[0], norm_out[1], b1.shape[1] * b1.shape[2], groups)
    return F.silu(b1.float() * a[:, None, None] + b[:, None, None]).to(h.dtype)
