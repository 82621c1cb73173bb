"""Kernels K1, K3 and K4: one whole shifted-window transformer block.

Three entry points of ``csrc/sw_block.cu``, one device function:

* :func:`sw_block` (K1) replaces the TPU kernel ``pgtformer_tpu/ops/
  pallas_attn.py:_pallas_sw_block_5d`` (via ``fused_sw_block_5d``): windows
  of T*wh*ww tokens are read straight from the ``[B, T, H, W, C]`` layout
  with the half-window roll applied as an address change and the shift mask
  derived from region labels.
* :func:`sw_block_tokens` (K3) replaces ``_pallas_sw_block`` (via
  ``fused_sw_block_tokens``): the same math on pre-partitioned window
  tokens ``[M, N, C]`` with the caller's additive mask ``[nW, N, N]``.
* :func:`sw_block_pair` (K4) replaces ``_pallas_sw_block_pair_5d`` (via
  ``fused_sw_block_pair_5d``): blocks [no-shift, shift] of one layer in one
  cooperative launch; block 0's bf16 output crosses a scratch tensor and a
  grid-wide barrier instead of a second launch.

On an H100 the block is compute-bound on paper (12*C^2 FLOP per token).
The kernel (``csrc/sw_block.cu``) is laid out by :func:`sw_plan`: a
consumer warpgroup owns a slab of 48 token rows (a 64-row ``wgmma`` tile);
a persistent CTA (one per SM) walks groups of ``nw`` slabs, and a producer
warpgroup feeds the weights by TMA through a ring of boxes of 64 x 64*nb
in shared memory, so a box leaves L2 once per ``nw`` slabs (the ``SW_RPS``
knob sets ``nw`` for K1 and K3, the counterpart of the TPU kernels' rows
per stripe; a slab's arithmetic does not depend on its CTA, so every ``nw``
gives the same output).  The four GEMMs run on ``wgmma`` m64n(64*nb) with
accumulators in registers; the window attention runs on ``mma.sync`` a
head group at a time; the fp32 residual waits in a scratch array the
wrapper allocates (:func:`_scratch`).  What bounds it is measured in
PERF.md.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version (:func:`sw_block_plain`, :func:`sw_block_tokens_plain`,
:func:`sw_block_pair_plain`) only for a tensor on the CPU.

Activations are bf16 or fp32, and the output takes the input's dtype, as
the TPU kernels do.  Under fp32 the input is rounded to bf16 first (JAX's
``xb = x.astype(bfloat16)``), every step inside is the bf16 block's, and
only the output is fp32: the kernel stores its fp32 residual sum unrounded.
The plain versions have the same fp32 form.  The XLA path that JAX
differentiates (``sw_block_tokens_xla``, ``sw_block_5d_xla``) computes in
x's dtype throughout; its ports are :func:`sw_block_tokens_xla`,
:func:`sw_block_xla` and :func:`sw_block_pair_xla`, which equal the plain
versions under bf16.

Gradients: when a gradient is recorded and x or a weight requires one, each
wrapper runs inside a ``torch.autograd.Function`` (the counterparts of the
JAX package's ``custom_vjp``s, ``ops/pallas_attn.py:202-215, 592-605,
874-885``).  Its forward launches the kernel on weights cast for it from
the live parameters on every call; its backward recomputes the block
through the XLA form in x's dtype (the plain version under bf16) with
autograd and returns the gradients of x, of every weight and of the
gathered relative-position bias.  There is no
backward kernel, in the JAX package either: the backward is the XLA
form's autograd graph, so it runs on cuBLAS products and ATen elementwise
passes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops import _build
from pgtformer_tpu_torch.ops.autograd import KernelFunction
from pgtformer_tpu_torch.ops.window import (
    shifted_window_mask, window_partition, window_reverse)


class SWBlockWeights(NamedTuple):
    """One block's weights.  Matrices are (out, in); for the kernel they are
    bf16 and the vectors fp32.  `rel_bias` is the gathered [heads, N, N]
    fp32 relative-position bias."""
    norm1_w: torch.Tensor
    norm1_b: torch.Tensor
    wq: torch.Tensor
    bq: torch.Tensor
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wp: torch.Tensor
    bp: torch.Tensor
    norm2_w: torch.Tensor
    norm2_b: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    rel_bias: torch.Tensor
    num_heads: int
    window: Tuple[int, int]

    def for_kernel(self) -> "SWBlockWeights":
        """bf16 contiguous matrices and fp32 contiguous vectors."""
        mats = {"wq", "wk", "wv", "wp", "w1", "w2"}
        conv = {}
        for name, t in self._asdict().items():
            if isinstance(t, torch.Tensor):
                dt = torch.bfloat16 if name in mats else torch.float32
                t = t.detach().to(dtype=dt).contiguous()
            conv[name] = t
        return SWBlockWeights(**conv)


def _layer_norm(z: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    zf = z.float()
    mu = zf.mean(-1, keepdim=True)
    var = ((zf - mu) ** 2).mean(-1, keepdim=True)
    y = (zf - mu) * torch.rsqrt(var + 1e-6)
    return (y * g.float() + b.float()).to(z.dtype)


def _block_tokens(x: torch.Tensor, w: SWBlockWeights, mask, n_windows_per_image: int,
                  res_dtype: torch.dtype) -> torch.Tensor:
    """The block on window tokens [M, N, C] in x's dtype with fp32 scores,
    its two residual adds and its output in `res_dtype`."""
    M, N, C = x.shape
    dt = x.dtype
    h = w.num_heads
    hd = C // h
    lin = lambda z, wt, bs: F.linear(z, wt.to(dt), bs.to(dt))
    hx = _layer_norm(x, w.norm1_w, w.norm1_b)
    q = lin(hx, w.wq, w.bq).reshape(M, N, h, hd) * (hd ** -0.5)
    k = lin(hx, w.wk, w.bk).reshape(M, N, h, hd)
    v = lin(hx, w.wv, w.bv).reshape(M, N, h, hd)
    attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    attn = attn + w.rel_bias[None].float()
    if mask is not None:
        nW = n_windows_per_image
        m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
        attn = (attn.reshape(M // nW, nW, h, N, N) + m[None, :, None]).reshape(M, h, N, N)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).reshape(M, N, C).to(dt)
    x = x.to(res_dtype) + lin(out, w.wp, w.bp).to(res_dtype)
    f = F.gelu(lin(_layer_norm(x, w.norm2_w, w.norm2_b).to(dt), w.w1, w.b1))
    return x + lin(f, w.w2, w.b2).to(res_dtype)


def sw_block_tokens_xla(x: torch.Tensor, w: SWBlockWeights, mask,
                        n_windows_per_image: int) -> torch.Tensor:
    """The block on window tokens [M, N, C] with an additive mask [nW, N, N]
    (numpy or tensor) or None, in x's dtype with fp32 scores (the math of
    the JAX package's sw_block_tokens_xla, which its custom VJP
    differentiates)."""
    return _block_tokens(x, w, mask, n_windows_per_image, x.dtype)


def sw_block_tokens_plain(x: torch.Tensor, w: SWBlockWeights, mask,
                          n_windows_per_image: int) -> torch.Tensor:
    """Plain PyTorch version of the token kernel: :func:`sw_block_tokens_xla`
    under bf16; under fp32 the kernel's fp32 form, x rounded to bf16, the
    bf16 block, the residual adds and the output in fp32."""
    if x.dtype == torch.float32:
        return _block_tokens(x.to(torch.bfloat16), w, mask, n_windows_per_image,
                             torch.float32)
    return sw_block_tokens_xla(x, w, mask, n_windows_per_image)


def _block_5d(x: torch.Tensor, w: SWBlockWeights, shift: Tuple[int, int],
              tokens) -> torch.Tensor:
    """roll -> partition -> `tokens` -> reverse -> unroll on [B, T, H, W, C]."""
    B, T, H, W, C = x.shape
    window = tuple(w.window)
    shifted = any(s > 0 for s in shift)
    h = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
    tok = window_partition(h, window)
    nW = (H // window[0]) * (W // window[1])
    mask = shifted_window_mask(T, H, W, window, tuple(shift)) if shifted else None
    tok = tokens(tok, w, mask, nW)
    h = window_reverse(tok, window, B, T, H, W)
    return torch.roll(h, (shift[0], shift[1]), dims=(2, 3)) if shifted else h


def sw_block_plain(x: torch.Tensor, w: SWBlockWeights,
                   shift: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the kernel on [B, T, H, W, C]: roll ->
    partition -> :func:`sw_block_tokens_plain` -> reverse -> unroll."""
    return _block_5d(x, w, shift, sw_block_tokens_plain)


def sw_block_xla(x: torch.Tensor, w: SWBlockWeights,
                 shift: Tuple[int, int]) -> torch.Tensor:
    """:func:`sw_block_plain` through :func:`sw_block_tokens_xla` (the JAX
    package's sw_block_5d_xla)."""
    return _block_5d(x, w, shift, sw_block_tokens_xla)


def sw_block_pair_plain(x: torch.Tensor, w0: SWBlockWeights, w1: SWBlockWeights,
                        shift: Tuple[int, int]) -> torch.Tensor:
    """Plain PyTorch version of the pair kernel: block 0 unshifted, then
    block 1 with `shift` (under fp32 block 0's fp32 result is rounded to
    bf16 as block 1's input, as the TPU kernel's carry is)."""
    return sw_block_plain(sw_block_plain(x, w0, (0, 0)), w1, shift)


def sw_block_pair_xla(x: torch.Tensor, w0: SWBlockWeights, w1: SWBlockWeights,
                      shift: Tuple[int, int]) -> torch.Tensor:
    """The pair through :func:`sw_block_xla`: what its backward
    differentiates."""
    return sw_block_xla(sw_block_xla(x, w0, (0, 0)), w1, shift)


SMEM_LIMIT = 232448      # dynamic shared memory one CTA may use on an H100
SLAB = 48                # token rows per consumer warpgroup (csrc/sw_block.cu)
TILE = 64                # weight boxes: 64 input columns x 64*nb output rows, bf16
TILE_BYTES = TILE * TILE * 2
MAX_NW = 2               # slabs (consumer warpgroups) per CTA
ROW_TABLE = 768          # per slab: 64 int region labels, 64 int64 row offsets
STATIC_SMEM = 512        # static shared memory a kernel may add (the pair's arguments)
X1_THREADS = SLAB // 16 * 32   # threads of a warpgroup that keep x1 values
RING_BYTES = 96 * 1024   # the weight ring's largest size
SMS = 132                # streaming multiprocessors of an H100 SXM, where no card says


class SWPlan(NamedTuple):
    """Launch geometry of the sw_block kernels, in the order of the C
    entries' ``plan`` array (the first twelve fields).  Offsets are bytes
    from the 1024-aligned start of dynamic shared memory: the weight ring
    (``stages`` slots of ``nb`` 64 x 64 tiles) at 0; slab s's A, B and X
    regions at ``off_slab + s * slab_bytes + (0, off_b, off_x)``; two row
    tables per slab (region labels, row offsets; the current slab's and the
    next one's) at ``off_lab``; the ring's mbarriers at ``off_bar``."""
    nw: int          # slabs per CTA (consumer warpgroups)
    stages: int      # weight-ring slots
    gw: int          # head-group width: lcm(hd, 64 * nb) columns of q, k and v
    nb: int          # product width in 64-column tiles: wgmma m64n(64*nb)k16
    off_slab: int
    slab_bytes: int
    off_b: int
    off_x: int
    off_lab: int
    off_bar: int
    smem: int        # dynamic shared memory of a CTA, alignment slack included
    grid: int        # persistent CTAs: at most one per SM, at most one per group
    nslab: int       # slabs of SLAB rows over the input

    def as_array(self):
        return (ctypes.c_int * 12)(*self[:12])

    @property
    def groups(self) -> int:
        """Groups of nw slabs; CTA b takes groups b, b + grid, ..."""
        return -(-self.nslab // self.nw)


def _align(n: int, to: int = 1024) -> int:
    return (n + to - 1) // to * to


def _carve(C: int, gw: int, nb: int, nw: int, stages: int) -> Dict[str, int]:
    """Shared-memory carve-up for nw slabs of width C, products of nb tiles
    and a ring of `stages` slots.  A and B buffers (LN and attention
    outputs, the GEMMs' A operand): 64-column chunks of 48 rows x 128 bytes;
    the 16 padding rows of a chunk's 64-row tile read the next 2 KB, which
    for the last chunk is the next region of the slab (B after A, X after
    B).  X: the q/k/v of one head group [3, 48, gw + 8] bf16.  The fp32
    residual lives in the x1 scratch and the output (bf16, or fp32 in the
    fp32 form) is stored from registers: neither takes shared memory."""
    a_bytes = _align(SLAB * C * 2)
    x_bytes = _align(max(3 * SLAB * (gw + 8) * 2, 2048))
    slab = 2 * a_bytes + x_bytes
    off_slab = stages * nb * TILE_BYTES
    off_lab = off_slab + nw * slab
    off_bar = off_lab + nw * 2 * ROW_TABLE
    return dict(off_slab=off_slab, slab_bytes=slab, off_b=a_bytes, off_x=2 * a_bytes,
                off_lab=off_lab, off_bar=off_bar, smem=off_bar + 16 * stages + 1024)


def _fits(C: int, gw: int, nb: int, nw: int) -> Optional[int]:
    """The deepest weight ring (at most RING_BYTES, at least 2 slots) beside
    `nw` slabs that fits shared memory, or None."""
    for stages in range(RING_BYTES // (nb * TILE_BYTES), 1, -1):
        if _carve(C, gw, nb, nw, stages)["smem"] <= SMEM_LIMIT - STATIC_SMEM:
            return stages
    return None


def _widths(C: int, hd: int):
    """Product widths nb (tiles of 64 columns) that the widths allow, the
    widest first, each with its head-group width."""
    for nb in (2, 1):
        gw = math.lcm(hd, TILE * nb)
        if C % gw == 0:
            yield nb, gw


def sw_plan(C: int, heads: int, N: int, nwin: int, pair: bool = False,
            sms: int = SMS) -> SWPlan:
    """The kernels' plan for `nwin` windows of N tokens at width C on a card
    of `sms` SMs: the ``SW_RPS`` knob's slabs per CTA, and where that is
    empty two slabs where both fit beside a ring, else one (always one for
    the pair kernel); the widest products that fit beside them; the
    deepest ring that fits (up to RING_BYTES).  The grid is persistent: one
    CTA per SM, or one per group of slabs where there are fewer groups; the
    slabs past the input (in a ragged last group) run on zeros and write
    nothing.  A knob value that does not fit raises ValueError."""
    hd = C // heads if heads > 0 and C % heads == 0 else 0
    if C % 64 or C > 512 or not hd or hd % 16 or hd > 64 or N not in (16, 48) or nwin <= 0:
        raise NotImplementedError(f"sw_block kernel: C={C} heads={heads} N={N} windows={nwin}")
    shapes = {n: [(nb, gw) for nb, gw in _widths(C, hd) if _fits(C, gw, nb, n)]
              for n in range(1, 1 + (1 if pair else MAX_NW))}
    fit = [n for n, s in shapes.items() if s]
    if not fit:
        raise NotImplementedError(f"sw_block kernel: C={C} hd={hd} does not fit shared memory")
    rps = knobs.get("SW_RPS")
    if rps == "":
        nw = fit[-1]
    else:
        nw = int(rps) if rps.strip().isdigit() else rps
        if nw not in fit:
            kernel = "sw_block_pair" if pair else "sw_block and sw_block_tokens"
            raise ValueError(f"SW_RPS={rps!r} does not fit {kernel} at C={C} hd={hd}; "
                             f"slabs per CTA that fit: {', '.join(map(str, fit))}")
    nb, gw = shapes[nw][0]
    stages = _fits(C, gw, nb, nw)
    nslab = -(-nwin * N // SLAB)
    return SWPlan(nw=nw, stages=stages, gw=gw, nb=nb, grid=min(sms, -(-nslab // nw)),
                  nslab=nslab, **_carve(C, gw, nb, nw, stages))


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch(plan: SWPlan, C: int, device: torch.device) -> torch.Tensor:
    """The x1 scratch of a launch: C / 2 fp32 values for each of X1_THREADS
    threads of each consumer warpgroup of the grid (L2-resident while it
    runs)."""
    return torch.empty(plan.grid * plan.nw * X1_THREADS * C // 2, dtype=torch.float32,
                       device=device)


_P = ctypes.c_void_p
_I = ctypes.c_int
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)


def _lib(define: str = "") -> ctypes.CDLL:
    """The kernels' library (built with the macro `define`, if given)."""
    lib = _build.load("sw_block", define)
    if lib.sw_block_launch.argtypes is None:
        # pointer table, plan; B T H W C heads wh ww sh sw out_f32; scale; stream
        lib.sw_block_launch.argtypes = [_PP, _IP] + [_I] * 11 + [ctypes.c_float, _P]
        # pointer table, plan, mask; Mwin N C heads nW out_f32; scale; stream
        lib.sw_block_tokens_launch.argtypes = [_PP, _IP, _P] + [_I] * 6 + [ctypes.c_float, _P]
        # two pointer tables, plan; B T H W C heads wh ww sh sw out_f32; scale; stream
        lib.sw_block_pair_launch.argtypes = [_PP, _PP, _IP] + [_I] * 11 + [ctypes.c_float, _P]
        for fn in (lib.sw_block_launch, lib.sw_block_tokens_launch,
                   lib.sw_block_pair_launch):
            fn.restype = _I
    return lib


def _check_weights(what: str, x: torch.Tensor, w: SWBlockWeights, N: int) -> None:
    """Raise unless `w` is what the kernels take for x [..., C]: bf16 (C, C)
    matrices, fp32 (C,) vectors and an fp32 [heads, N, N] bias, contiguous on
    x's device, at a width and window size the kernel supports."""
    C = x.shape[-1]
    heads = w.num_heads
    hd = C // heads
    if (C % 64 or C > 512 or C % heads or hd % 16 or hd > 64 or N % 16 or 48 % N):
        raise NotImplementedError(f"{what} kernel: C={C} heads={heads} N={N}")
    mats = (w.wq, w.wk, w.wv, w.wp, w.w1, w.w2)
    vecs = (w.norm1_w, w.norm1_b, w.bq, w.bk, w.bv, w.bp, w.norm2_w,
            w.norm2_b, w.b1, w.b2)
    for t in mats:
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (C, C)
                or not t.is_contiguous() or t.device != x.device):
            raise NotImplementedError(f"{what} kernel: weights must be bf16 "
                                      "(C, C) contiguous on x's device")
    for t in vecs:
        if (t.dtype != torch.float32 or tuple(t.shape) != (C,)
                or not t.is_contiguous() or t.device != x.device or t.data_ptr() % 16):
            raise NotImplementedError(f"{what} kernel: vectors must be 16-byte aligned fp32 (C,)")
    rb = w.rel_bias
    if (rb.dtype != torch.float32 or tuple(rb.shape) != (heads, N, N)
            or not rb.is_contiguous() or rb.device != x.device):
        raise NotImplementedError(f"{what} kernel: rel_bias must be fp32 [h, N, N]")


_IO_DTYPES = (torch.bfloat16, torch.float32)


def _io(x: torch.Tensor):
    """(x as the kernel reads it, whether it writes fp32): bf16 as given;
    fp32 rounded to bf16, with an fp32 output."""
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16), 1
    return x, 0


def _check_5d(what: str, x: torch.Tensor, w: SWBlockWeights, shift) -> None:
    if x.dtype not in _IO_DTYPES or x.dim() != 5 or not x.is_contiguous() or x.data_ptr() % 16:
        raise NotImplementedError(
            f"{what} kernel takes contiguous 16-byte aligned bf16 or fp32 [B,T,H,W,C], got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    B, T, H, W, C = x.shape
    wh, ww = w.window
    if H % wh or W % ww or not (0 <= shift[0] < wh and 0 <= shift[1] < ww):
        raise NotImplementedError(
            f"{what} kernel: window={w.window} H={H} W={W} shift={shift}")
    _check_weights(what, x, w, T * wh * ww)


def _pointers(x: torch.Tensor, out: torch.Tensor, x1s: torch.Tensor, w: SWBlockWeights):
    """The kernel's table of 20 device pointers, in the order
    csrc/sw_block.cu reads it."""
    return (ctypes.c_void_p * 20)(*(t.data_ptr() for t in (
        x, out, x1s, w.norm1_w, w.norm1_b, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, w.wp, w.bp,
        w.norm2_w, w.norm2_b, w.w1, w.b1, w.w2, w.b2, w.rel_bias)))


def sw_block(x: torch.Tensor, w: SWBlockWeights,
             shift: Tuple[int, int]) -> torch.Tensor:
    """One SW transformer block on x [B, T, H, W, C], bf16 or fp32 (the
    output takes x's dtype).

    CPU tensor: :func:`sw_block_plain`.  CUDA tensor: the Hopper kernel,
    with `w` the live parameters or prepared by
    :meth:`SWBlockWeights.for_kernel`; raises on any dtype, layout or
    geometry the kernel does not take.  A recorded gradient goes through
    the autograd Function (module docstring)."""
    if _recording(x, w):
        weights = lambda t: SWBlockWeights(*t, w.num_heads, w.window)
        return KernelFunction.apply(
            lambda xx, *t: _sw_block(xx, weights(t), shift),
            lambda xx, *t: sw_block_xla(xx, weights(t), shift), x, *w[:_NT])
    return _sw_block(x, w, shift)


def _sw_block(x: torch.Tensor, w: SWBlockWeights, shift: Tuple[int, int]) -> torch.Tensor:
    if x.device.type == "cpu":
        return sw_block_plain(x, w, shift)
    if not x.is_cuda:
        raise NotImplementedError(f"sw_block: device {x.device}")
    out = launch_5d(_lib(), x, _kernel_weights(w), shift)
    sw_block.launches += 1
    return out


sw_block.launches = 0


def launch_5d(lib: ctypes.CDLL, x: torch.Tensor, w: SWBlockWeights,
              shift: Tuple[int, int]) -> torch.Tensor:
    """K1 from the library `lib` (:func:`_lib`) on a CUDA tensor x, with
    :func:`sw_block`'s checks; counts no launch."""
    _check_5d("sw_block", x, w, shift)
    B, T, H, W, C = x.shape
    wh, ww = w.window
    xb, f32 = _io(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = sw_plan(C, w.num_heads, T * wh * ww, B * (H // wh) * (W // ww), sms=_sms(x.device))
    code = lib.sw_block_launch(
        _pointers(xb, out, _scratch(plan, C, x.device), w), plan.as_array(), B, T, H, W, C,
        w.num_heads, wh, ww, int(shift[0]), int(shift[1]), f32,
        float((C // w.num_heads) ** -0.5), stream)
    _build.check(code, "sw_block launch")
    return out


def sw_block_tokens(x: torch.Tensor, w: SWBlockWeights, mask,
                    n_windows_per_image: int) -> torch.Tensor:
    """One SW transformer block on window tokens x [M, N, C], bf16 or fp32
    (window m is window m % n_windows_per_image of its image); `mask` is
    None or an additive [nW, N, N] array added to the scores.

    CPU tensor: :func:`sw_block_tokens_plain` (mask: numpy or tensor).  CUDA
    tensor: the Hopper kernel, `mask` an fp32 tensor on x's device; raises
    on anything the kernel does not take.  A recorded gradient (none for the
    mask) goes through the autograd Function."""
    if _recording(x, w):
        weights = lambda t: SWBlockWeights(*t, w.num_heads, w.window)
        return KernelFunction.apply(
            lambda xx, *t: _sw_block_tokens(xx, weights(t), mask, n_windows_per_image),
            lambda xx, *t: sw_block_tokens_xla(xx, weights(t), mask, n_windows_per_image),
            x, *w[:_NT])
    return _sw_block_tokens(x, w, mask, n_windows_per_image)


def _sw_block_tokens(x: torch.Tensor, w: SWBlockWeights, mask,
                     n_windows_per_image: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return sw_block_tokens_plain(x, w, mask, n_windows_per_image)
    if not x.is_cuda:
        raise NotImplementedError(f"sw_block_tokens: device {x.device}")
    if x.dtype not in _IO_DTYPES or x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise NotImplementedError(
            f"sw_block_tokens kernel takes contiguous 16-byte aligned bf16 or fp32 [M,N,C], got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    Mw, N, C = x.shape
    nW = int(n_windows_per_image)
    w = _kernel_weights(w)
    _check_weights("sw_block_tokens", x, w, N)
    if nW <= 0 or Mw % nW:
        raise NotImplementedError(f"sw_block_tokens kernel: M={Mw} windows, nW={nW}")
    if mask is not None and not (
            isinstance(mask, torch.Tensor) and mask.dtype == torch.float32
            and tuple(mask.shape) == (nW, N, N) and mask.is_contiguous()
            and mask.device == x.device):
        raise NotImplementedError(
            "sw_block_tokens kernel: mask must be a contiguous fp32 [nW, N, N] "
            "tensor on x's device")
    xb, f32 = _io(x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = sw_plan(C, w.num_heads, N, Mw, sms=_sms(x.device))
    code = _lib().sw_block_tokens_launch(
        _pointers(xb, out, _scratch(plan, C, x.device), w), plan.as_array(),
        None if mask is None else mask.data_ptr(),
        Mw, N, C, w.num_heads, nW, f32, float((C // w.num_heads) ** -0.5), stream)
    _build.check(code, "sw_block_tokens launch")
    sw_block_tokens.launches += 1
    return out


sw_block_tokens.launches = 0


def sw_block_pair(x: torch.Tensor, w0: SWBlockWeights, w1: SWBlockWeights,
                  shift: Tuple[int, int]) -> torch.Tensor:
    """Blocks [no-shift with `w0`, `shift` with `w1`] of one layer on
    x [B, T, H, W, C], bf16 or fp32, in one launch.

    CPU tensor: :func:`sw_block_pair_plain`.  CUDA tensor: the Hopper
    kernel; the result equals ``sw_block(sw_block(x, w0, (0, 0)), w1,
    shift)`` bit for bit.  Raises on anything the kernel does not take.  A
    recorded gradient goes through the autograd Function."""
    if w0.num_heads != w1.num_heads or tuple(w0.window) != tuple(w1.window):
        raise NotImplementedError("sw_block_pair: the two blocks must share heads and window")
    if _recording(x, w0, w1):
        pair = lambda t: (SWBlockWeights(*t[:_NT], w0.num_heads, w0.window),
                          SWBlockWeights(*t[_NT:], w1.num_heads, w1.window))
        return KernelFunction.apply(
            lambda xx, *t: _sw_block_pair(xx, *pair(t), shift),
            lambda xx, *t: sw_block_pair_xla(xx, *pair(t), shift), x, *w0[:_NT], *w1[:_NT])
    return _sw_block_pair(x, w0, w1, shift)


def _sw_block_pair(x: torch.Tensor, w0: SWBlockWeights, w1: SWBlockWeights,
                   shift: Tuple[int, int]) -> torch.Tensor:
    if x.device.type == "cpu":
        return sw_block_pair_plain(x, w0, w1, shift)
    if not x.is_cuda:
        raise NotImplementedError(f"sw_block_pair: device {x.device}")
    w0, w1 = _kernel_weights(w0), _kernel_weights(w1)
    _check_5d("sw_block_pair", x, w0, (0, 0))
    _check_5d("sw_block_pair", x, w1, shift)
    B, T, H, W, C = x.shape
    wh, ww = w0.window
    xb, f32 = _io(x)
    scratch = torch.empty_like(xb)      # block 0's result, bf16 (block 1's input)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    plan = sw_plan(C, w0.num_heads, T * wh * ww, B * (H // wh) * (W // ww), pair=True,
                   sms=_sms(x.device))
    x1s = _scratch(plan, C, x.device)
    code = _lib().sw_block_pair_launch(
        _pointers(xb, scratch, x1s, w0), _pointers(scratch, out, x1s, w1), plan.as_array(),
        B, T, H, W, C, w0.num_heads, wh, ww, int(shift[0]), int(shift[1]), f32,
        float((C // w0.num_heads) ** -0.5), stream)
    _build.check(code, "sw_block_pair launch")
    sw_block_pair.launches += 1
    return out


sw_block_pair.launches = 0


# -- gradients: the kernel forward, the plain version's backward ---------------

_NT = 17                 # tensors of SWBlockWeights, in field order


def _recording(x: torch.Tensor, *ws: SWBlockWeights) -> bool:
    """A gradient is recorded and x or a weight tensor requires one."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for w in ws for t in w[:_NT]))


def _kernel_weights(w: SWBlockWeights) -> SWBlockWeights:
    """`w` as the kernel takes it: unchanged when already cast (the serving
    cache), else cast from the live parameters."""
    return w if w.wq.dtype == torch.bfloat16 and not w.wq.requires_grad else w.for_kernel()
