"""Reusable blocks on channels-last tensors (PyTorch port).

Counterparts of the JAX package's ``nn/blocks.py``: ResnetBlock,
Downsample, Upsample, Mlp, WindowAttention3D, SWTransformerBlock (also its
cross-attention form), EncoderLayer and DecoderLayer.  Public I/O is ``[B, T, H, W, C]`` or ``[N, H, W, C]``; convs
run on permuted views (channels_last memory format, no copies).  Parameter
names follow the reference state_dict (``blocks.1.attn.q.weight``, ...).

With ``use_pallas=True`` and a CUDA tensor, :class:`EncoderLayer` runs
every block through the hand-written kernels of ``ops/sw_block.py``
wherever H and W divide by the window (K1 by default; K3 under
``SW_KERNEL=tokens``, K4 under ``SW_PAIR=1``), and raises otherwise; on the
CPU it runs their plain versions.  Under a recorded gradient it hands the
kernels the live parameters, and they run through their autograd
Functions, whose backward is the XLA form's.  With ``use_pallas=False`` (the
default, as in JAX) it runs its :class:`SWTransformerBlock` stack on any
device.  :class:`DecoderLayer`'s cross blocks (self-attention,
then cross-attention, then the MLP) run plain PyTorch on every device: K1
fuses a whole self-attention block, MLP included, so it cannot serve them,
and JAX runs them with XLA too.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.ops.bias_add import bias_add
from pgtformer_tpu_torch.ops.fused_conv import (
    ResBlockKernelWeights, conv_kernel_hwio, phase_kernels_2x2)
from pgtformer_tpu_torch.ops.group_norm import (
    affine_round, group_norm_silu, group_norm_silu_plain, sum_sumsq)
from pgtformer_tpu_torch.ops.sw_block import (
    SWBlockWeights, sw_block, sw_block_pair, sw_block_tokens)
from pgtformer_tpu_torch.ops.window import (
    effective_window_shift, relative_position_index, shifted_window_mask,
    window_partition, window_reverse)


def bias_apart(x: torch.Tensor) -> bool:
    """Whether a biased conv on x runs cuDNN without its bias and adds the
    bias through ``ops/bias_add.py``: a bf16 CUDA tensor with no gradient
    recorded.  Everything else keeps the module's own call."""
    return x.dtype == torch.bfloat16 and x.is_cuda and not torch.is_grad_enabled()


def conv_to_nhwc(conv: nn.Conv2d, xc: torch.Tensor,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv module applied to an NCHW tensor, as [N, H, W, C]; with
    `residual` (of the output's shape) added after it.  Where
    :func:`bias_apart`, the conv runs without its bias and one pass adds
    the bias and the residual over its output, rounded where ATen's bias
    add and ``residual + y`` round; a conv with forward hooks keeps its
    module call, so that they run."""
    if (conv.bias is not None and bias_apart(xc)
            and not (conv._forward_hooks or conv._forward_pre_hooks)):
        return _conv_then_bias(conv, xc, residual)
    y = conv(xc).permute(0, 2, 3, 1)
    return y if residual is None else residual + y


def _conv_then_bias(conv: nn.Conv2d, xc: torch.Tensor,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv's product on an NCHW tensor without its bias, as [N, H, W,
    C], then the bias (and `residual`) added in place by one pass."""
    y = conv._conv_forward(xc, conv.weight.to(xc.dtype), None).permute(0, 2, 3, 1)
    return bias_add(y, conv.bias, residual)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor,
              residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Apply an NCHW conv module to [N, H, W, C], then add `residual`
    where given (:func:`conv_to_nhwc`)."""
    return conv_to_nhwc(conv, x.permute(0, 3, 1, 2), residual)


class KeepFloat32(nn.Module):
    """Mixin: the module moves with the model, but its parameters and buffers
    keep their fp32 values under a dtype cast, as flax keeps parameters in
    fp32 whatever the compute dtype."""

    def _apply(self, fn, *args, **kwargs):
        def keep(t):
            r = fn(t)
            return t.to(r.device) if r.dtype != t.dtype else r
        return super()._apply(keep, *args, **kwargs)


class GroupNorm(KeepFloat32, nn.GroupNorm):
    """GroupNorm(32, eps=1e-6, affine) on [N, H, W, C], followed by SiLU when
    called with ``silu=True``.  The affine stays fp32; a lower-precision
    input is normalized and scaled in fp32 from fp32 statistics (variance
    E[x^2] - mean^2, as flax) and rounded once.  A bf16 input on the card
    with no gradient recorded runs the kernel pair of
    ``ops/group_norm.py``; every other input runs plain PyTorch."""

    def __init__(self, num_channels: int):
        super().__init__(32, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            y = F.group_norm(x.permute(0, 3, 1, 2), self.num_groups, self.weight,
                             self.bias, self.eps).permute(0, 2, 3, 1)
            return F.silu(y) if silu else y
        norm = (group_norm_silu_plain if torch.is_grad_enabled() or x.dtype != torch.bfloat16
                else group_norm_silu)
        return norm(x, self.weight, self.bias, silu, self.num_groups, self.eps)


class LayerNorm(KeepFloat32, nn.LayerNorm):
    """LayerNorm over the last dim with an fp32 affine; a lower-precision
    input is normalized and scaled in fp32 (variance E[x^2] - mean^2, as
    flax) and rounded once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        s1, s2 = sum_sumsq(x, (-1,))
        mean, msq = s1[..., None] / x.shape[-1], s2[..., None] / x.shape[-1]
        rstd = torch.rsqrt((msq - mean * mean).clamp_min(0.0) + self.eps)
        xn = torch.addcmul(-mean * rstd, x, rstd)
        return affine_round(xn, self.weight, self.bias, x.dtype)


def layer_norm(dim: int) -> LayerNorm:
    """LayerNorm with the JAX package's eps (1e-6)."""
    return LayerNorm(dim, eps=1e-6)


def _fold(x: torch.Tensor):
    if x.dim() == 5:
        B, T, H, W, C = x.shape
        return x.reshape(B * T, H, W, C), (B, T)
    return x, None


def _unfold(x: torch.Tensor, lead) -> torch.Tensor:
    return x if lead is None else x.reshape(*lead, *x.shape[1:])


class KernelWeightCache(nn.Module):
    """A module that keeps a derived copy of its weights: in the layout of a
    hand-written kernel, or summed and rounded for an evaluation plan.  The
    copy is made at first use and dropped whenever the parameters move,
    change dtype, are loaded or change in place (an optimizer step: their
    version counters move)."""

    def __init__(self):
        super().__init__()
        self._kernel_cache = None

    def _cached(self, key, build, sources: Optional[Tuple[nn.Module, ...]] = None):
        """The copy made by `build()` for `key`, remade when the key or the
        version counter of a parameter it is built from (of `sources`, by
        default of the whole module) has changed since."""
        params = self.parameters() if sources is None else (
            p for m in sources for p in m.parameters())
        key = (key, tuple(p._version for p in params))
        if self._kernel_cache is None or self._kernel_cache[0] != key:
            self._kernel_cache = (key, build())
        return self._kernel_cache[1]

    def _apply(self, *args, **kwargs):
        self._kernel_cache = None
        return super()._apply(*args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kernel_cache = None
        return super()._load_from_state_dict(*args, **kwargs)


class ResnetBlock(KernelWeightCache):
    """GroupNorm -> SiLU -> conv3x3, twice, with a 1x1 shortcut on a channel
    change (named `nin_shortcut`, or `conv_out` in the Fuse-SFT block)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 shortcut_name: str = "nin_shortcut"):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut_name = shortcut_name if in_channels != out_channels else None
        if self.shortcut_name:
            self.add_module(shortcut_name, nn.Conv2d(in_channels, out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        h = self.norm2(conv_nhwc(self.conv1, self.norm1(x, silu=True)), silu=True)
        if self.shortcut_name:
            x = conv_nhwc(getattr(self, self.shortcut_name), x)
        return _unfold(conv_nhwc(self.conv2, h, residual=x), lead)

    def kernel_weights(self) -> ResBlockKernelWeights:
        """This block's weights for ``ops/fused_conv.py:fused_resblock``
        (cached): fp32 norm affines and biases, bf16 [3, 3, C, Co] kernels."""
        f32 = lambda p: p.detach().float().contiguous()
        sc = getattr(self, self.shortcut_name) if self.shortcut_name else None
        return self._cached(None, lambda: ResBlockKernelWeights(
            f32(self.norm1.weight), f32(self.norm1.bias),
            conv_kernel_hwio(self.conv1.weight), f32(self.conv1.bias),
            f32(self.norm2.weight), f32(self.norm2.bias),
            conv_kernel_hwio(self.conv2.weight), f32(self.conv2.bias),
            conv_kernel_hwio(sc.weight)[0, 0] if sc is not None else None,
            f32(sc.bias) if sc is not None else None))


class Float32Conv2d(KeepFloat32, nn.Conv2d):
    """A conv whose weight and bias stay fp32 under a dtype cast; it runs in
    its input's dtype, with the parameters rounded to it at use."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None and bias_apart(x):
            return _conv_then_bias(self, x).permute(0, 3, 1, 2)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a module computes in on x: autocast's where it is on for
    x's device, else x's own."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


def _taps4(k: torch.Tensor, dim: int) -> torch.Tensor:
    """Along `dim` of a 3x3 kernel, the four taps of nearest-up2x + conv3x3
    as one conv over the 2x-dilated input: {r0, r0+r1, r1+r2, r2}."""
    s0, s1, s2 = k.unbind(dim)
    return torch.stack([s0, s0 + s1, s1 + s2, s2], dim)


def subpixel_kernel(w3: torch.Tensor, plan: str) -> torch.Tensor:
    """The ``SUBPIXEL`` `plan`'s kernel from a conv3x3 weight [o, i, 3, 3],
    summed in its dtype: for ``dilated`` ``K44[u, v] = sum A[u, r] A[v, c]
    k3[r, c]`` in conv_transpose2d's layout [i, o, 4, 4] (taps flipped);
    for ``quad`` the phase kernels [2(a), 2(b), o, i, 2, 2]."""
    if plan == "dilated":
        return _taps4(_taps4(w3, 2), 3).flip(2, 3).transpose(0, 1)
    return phase_kernels_2x2(w3.permute(2, 3, 1, 0)).permute(0, 1, 5, 4, 2, 3)


def add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y [N, H, W, C] + bias [C] of y's dtype: where :func:`bias_apart`, in
    place over y (a conv's fresh output) through ``ops/bias_add.py``."""
    return bias_add(y, bias) if bias_apart(y) else y + bias


def subpixel_up_conv(x: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
                     plan: str) -> torch.Tensor:
    """conv3x3(nearest_up2(x)) of x [N, H, W, C] on the source grid by the
    ``SUBPIXEL`` `plan`, with its kernel `k` (:func:`subpixel_kernel`) and
    `bias` in x's dtype, the bias added after the conv: ``dilated``, one
    transposed conv (stride 2, padding 1: the 2x-dilated input padded by 2);
    ``quad``, four 2x2 convs with the asymmetric pads, interleaved."""
    xc = x.permute(0, 3, 1, 2)
    if plan == "dilated":
        return add_bias(F.conv_transpose2d(xc, k, stride=2, padding=1).permute(0, 2, 3, 1), bias)
    N, H, W, C = x.shape
    phases = [add_bias(F.conv2d(F.pad(xc, (1 - b, b, 1 - a, a)), k[a, b]).permute(0, 2, 3, 1),
                       bias)
              for a in (0, 1) for b in (0, 1)]
    y = torch.stack(phases).reshape(2, 2, N, H, W, C).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(N, 2 * H, 2 * W, C)


class Upsample(KernelWeightCache):
    """Nearest-2x upsample, then conv3x3.  The conv's parameters stay fp32.

    With `subpixel` (the JAX package's field and default) the conv runs on
    the source grid by the ``SUBPIXEL`` knob's plan
    (:func:`subpixel_up_conv`): ``dilated``, one transposed conv with the
    4x4 kernel ``K44 = A k3 A^T``; ``quad``, four 2x2 phase convs
    (:func:`phase_kernels_2x2`) interleaved.  Both sum their kernels from the
    fp32 taps, round them once to the compute dtype and add the bias after
    the conv in that dtype, as JAX does: the 4x4 kernel's taps are the phase
    kernels' bit for bit, so the two plans differ only in the order of the
    conv's fp32 sums.  On a CPU tensor both run the phase convs: the one
    transposed conv of oneDNN drew the fp32 stage-I step (LPIPS at full
    weight) 1.0e-3 of a gradient leaf's scale away from the JAX package's
    CPU step, the phase convs 1.1e-5 (tests/test_torch_train_fp64.py), and
    in bf16 each lies as close to either JAX plan as JAX's two lie to each
    other.  Without `subpixel` (the VQGAN family, as in JAX) the input is
    upsampled and convolved as is.  Under a recorded gradient the kernels
    are derived from the live parameter, else cached."""

    def __init__(self, channels: int, with_conv: bool = True, subpixel: bool = True):
        super().__init__()
        self.with_conv = with_conv
        self.subpixel = subpixel
        if with_conv:
            self.conv = Float32Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        if self.with_conv and self.subpixel:
            dt = compute_dtype(x)
            # on the CPU both plans run the phase convs (see the docstring)
            plan = knobs.get("SUBPIXEL") if x.is_cuda else "quad"
            k, bias = self._plan_weights(plan, dt)
            return _unfold(subpixel_up_conv(x.to(dt), k, bias, plan), lead)
        y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        if self.with_conv:
            y = self.conv(y)
        return _unfold(y.permute(0, 2, 3, 1), lead)

    def _plan_weights(self, plan: str, dt: torch.dtype):
        """(kernel, bias) of the `plan`, rounded to `dt`: the transposed
        conv's [C, C, 4, 4] kernel for ``dilated``, the phase kernels [2(a),
        2(b), C, C, 2, 2] for ``quad``."""
        def build():
            with torch.autocast(self.conv.weight.device.type, enabled=False):
                k = subpixel_kernel(self.conv.weight.float(), plan)
                return k.to(dt).contiguous(), self.conv.bias.to(dt)
        if torch.is_grad_enabled() and self.conv.weight.requires_grad:
            return build()
        return self._cached((plan, dt), build)

    def kernel_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bf16 phase kernels [2, 2, 2, 2, C, C], fp32 bias) for
        ``ops/fused_conv.py:subpixel_up_conv3x3`` (cached): the 3x3 kernel
        pre-summed in fp32 into the four 2x2 phase kernels, then rounded."""
        def build():
            k2 = phase_kernels_2x2(self.conv.weight.detach().permute(2, 3, 1, 0))
            return k2.to(torch.bfloat16).contiguous(), self.conv.bias.detach().float().contiguous()
        return self._cached(None, build)


class Downsample(nn.Module):
    """Stride-2 conv3x3 after a (0,1)x(0,1) pad, or 2x2 average pool."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = _fold(x)
        y = x.permute(0, 3, 1, 2)
        if self.with_conv:
            return _unfold(conv_to_nhwc(self.conv, F.pad(y, (0, 1, 0, 1))), lead)
        return _unfold(F.avg_pool2d(y, 2, 2).permute(0, 2, 3, 1), lead)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2."""

    def __init__(self, in_features: int, hidden_features: Optional[int] = None):
        super().__init__()
        hidden = hidden_features or in_features
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention3D(nn.Module):
    """Window attention over spatio-temporal window tokens with a 3D
    relative-position bias.  I/O: queries [B*nW, N, C], optional keys and
    values `kv` [B*nW, N2, C] of another frame count (cross-attention;
    default: the queries' tokens), optional additive mask [nW, N, N2]
    (numpy)."""

    def __init__(self, dim: int, num_frames: int, window_size: Tuple[int, int],
                 num_heads: int):
        super().__init__()
        self.dim = dim
        self.num_frames = num_frames
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        wh, ww = self.window_size
        table = (2 * num_frames - 1) * (2 * wh - 1) * (2 * ww - 1)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(relative_position_index(num_frames, num_frames,
                                                    self.window_size), dtype=torch.long),
            persistent=False)
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def init_extra(self, g: torch.Generator) -> None:
        t = self.relative_position_bias_table
        with torch.no_grad():
            t.copy_((torch.randn(t.shape, generator=g) * 0.02).clamp_(-0.04, 0.04))

    def rel_bias(self, num_frames_kv: Optional[int] = None) -> torch.Tensor:
        """Gathered bias [heads, N, N2] (keys of `num_frames_kv` frames,
        default the queries' count)."""
        idx = self.relative_position_index
        if num_frames_kv not in (None, self.num_frames):
            idx = torch.as_tensor(relative_position_index(self.num_frames, num_frames_kv,
                                                          self.window_size),
                                  dtype=torch.long, device=idx.device)
        N1, N2 = idx.shape
        b = self.relative_position_bias_table[idx.reshape(-1)]
        return b.reshape(N1, N2, self.num_heads).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[np.ndarray] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        Bn, N, C = x.shape
        kv_in = x if kv is None else kv
        N2 = kv_in.shape[1]
        h = self.num_heads
        hd = C // h
        q = self.q(x).reshape(Bn, N, h, hd) * (hd ** -0.5)
        kv = self.kv(kv_in)
        k = kv[..., :C].reshape(Bn, N2, h, hd)
        v = kv[..., C:].reshape(Bn, N2, h, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        wh, ww = self.window_size
        attn = attn + self.rel_bias(N2 // (wh * ww))[None].float()
        if mask is not None:
            nW = mask.shape[0]
            m = torch.as_tensor(mask, dtype=torch.float32, device=x.device)
            attn = (attn.reshape(Bn // nW, nW, h, N, N2) + m[None, :, None]).reshape(Bn, h, N, N2)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        return self.proj(out.reshape(Bn, N, C).to(x.dtype))


class SWTransformerBlock(KernelWeightCache):
    """(Shifted-)window self-attention block on [B, T, H, W, C]:
    LN -> (shift) -> W-MSA -> LN -> MLP (the reference encoder block).

    With `cross` (the reference decoder block, rstt_layers.py:340-497) a
    cross-attention stage follows the self-attention: queries LN ``norm2``
    of x, keys and values LN ``norm_kv`` of the forward's `attn_kv`
    [B, T2, H, W, C] through ``attn2``, under the spatial mask tiled T x T2;
    the MLP then reads ``norm3``."""

    def __init__(self, dim: int, num_heads: int, num_frames: int,
                 window_size: Tuple[int, int] = (8, 8),
                 shift_size: Tuple[int, int] = (0, 0), mlp_ratio: float = 4.0,
                 cross: bool = False):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.num_heads = num_heads
        self.cross = cross
        self.norm1 = layer_norm(dim)
        self.attn = WindowAttention3D(dim, num_frames, window_size, num_heads)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if cross:
            self.attn2 = WindowAttention3D(dim, num_frames, window_size, num_heads)
            self.norm_kv = layer_norm(dim)
            self.norm3 = layer_norm(dim)

    def live_weights(self) -> SWBlockWeights:
        """This block's parameters as :func:`sw_block` takes them, views of
        the live tensors (the bias gathered from its table), so that a
        recorded gradient reaches every parameter."""
        a, m = self.attn, self.mlp
        C = a.dim
        return SWBlockWeights(
            self.norm1.weight, self.norm1.bias,
            a.q.weight, a.q.bias, a.kv.weight[:C], a.kv.bias[:C],
            a.kv.weight[C:], a.kv.bias[C:], a.proj.weight, a.proj.bias,
            self.norm2.weight, self.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
            a.rel_bias(), self.num_heads, self.window_size)

    def kernel_weights(self, device: torch.device) -> SWBlockWeights:
        """This block's weights for :func:`sw_block` with no gradient
        recorded: the live parameters for the CPU, bf16/fp32 copies made once
        (and cached until a parameter changes) for CUDA.  Under a recorded
        gradient the layer calls :meth:`live_weights` instead: a cached copy
        carries no gradient."""
        if device.type == "cpu":
            with torch.no_grad():
                return self.live_weights()
        return self._cached(device, lambda: self.live_weights().for_kernel())

    def _run_windowed(self, x, window, shift, mask, attn=None, kv=None):
        """Pad -> cyclic shift -> partition -> attend (`attn`, default the
        self-attention; keys and values from `kv` when given) -> reverse ->
        crop."""
        B, T, H, W, C = x.shape
        attn = self.attn if attn is None else attn
        pad_b = (window[0] - H % window[0]) % window[0]
        pad_r = (window[1] - W % window[1]) % window[1]
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            if kv is not None:
                kv = F.pad(kv, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3))
            if kv is not None:
                kv = torch.roll(kv, (-shift[0], -shift[1]), dims=(2, 3))
        else:
            mask = None
        kvw = window_partition(kv, window) if kv is not None else None
        out = attn(window_partition(x, window), mask=mask, kv=kvw)
        out = window_reverse(out, window, B, T, Hp, Wp)
        if shifted:
            out = torch.roll(out, (shift[0], shift[1]), dims=(2, 3))
        return out[:, :, :H, :W, :]

    def forward(self, x: torch.Tensor, attn_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, T, H, W, C = x.shape
        window, shift = effective_window_shift((H, W), self.window_size, self.shift_size)
        if window != self.window_size or T != self.attn.num_frames:
            raise NotImplementedError(
                f"SWTransformerBlock built for {self.attn.num_frames} frames of "
                f"{self.window_size} windows, got T={T} and a {H}x{W} map")
        Hp = -(-H // window[0]) * window[0]
        Wp = -(-W // window[1]) * window[1]
        mask = (shifted_window_mask(T, Hp, Wp, window, shift)
                if any(s > 0 for s in shift) else None)
        x = x + self._run_windowed(self.norm1(x), window, shift, mask)
        if not self.cross:
            return x + self.mlp(self.norm2(x))
        # the shift labels repeat in every frame, so the cross mask is the
        # spatial mask tiled T x T2
        T2 = attn_kv.shape[1]
        mask_kv = None
        if mask is not None:
            n_sp = window[0] * window[1]
            mask_kv = np.tile(mask[:, :n_sp, :n_sp], (1, T, T2))
        x = x + self._run_windowed(self.norm2(x), window, shift, mask_kv, self.attn2,
                                   self.norm_kv(attn_kv))
        return x + self.mlp(self.norm3(x))


class EncoderLayer(nn.Module):
    """`depth` SW blocks with alternating shift (0 / window//2) on
    [B, T, H, W, C].

    `use_pallas` (the JAX package's name and default) picks the plan.
    False: the module composition, the :class:`SWTransformerBlock` stack in
    plain PyTorch on any device (the counterpart of JAX's XLA path).  True:
    where H and W divide by the window the blocks run through
    ``ops/sw_block.py`` (the kernels on CUDA, their plain versions on the
    CPU) under one of three evaluation plans (knobs ``SW_KERNEL`` and
    ``SW_PAIR``), which all compute the same function: one 5-D block per
    launch (default); roll -> partition -> token block -> reverse -> unroll
    (``tokens``); or each [no-shift, shift] pair of blocks in one launch
    (``SW_PAIR=1`` with ``5d``), any leftover block on its own.  Where the
    window does not divide H or W, True runs the stack on the CPU and
    raises on CUDA; JAX takes its XLA path there without a word, the port
    asks the caller for ``use_pallas=False``."""

    def __init__(self, dim: int, depth: int, num_heads: int, num_frames: int,
                 window_size: Tuple[int, int] = (8, 8), mlp_ratio: float = 4.0,
                 use_pallas: bool = False):
        super().__init__()
        self.use_pallas = use_pallas
        self.window_size = tuple(window_size)
        half = tuple(w // 2 for w in self.window_size)
        self.blocks = nn.ModuleList([
            SWTransformerBlock(dim, num_heads, num_frames, self.window_size,
                               (0, 0) if i % 2 == 0 else half, mlp_ratio)
            for i in range(depth)])
        self._masks = {}        # (T, H, W, shift, device) -> fp32 mask tensor

    def _apply(self, *args, **kwargs):
        self._masks = {}
        return super()._apply(*args, **kwargs)

    def _mask(self, x: torch.Tensor, shift: Tuple[int, int]) -> torch.Tensor:
        """The shifted-window mask [nW, N, N] as an fp32 tensor on x's
        device, uploaded once per geometry."""
        _, T, H, W, _ = x.shape
        key = (T, H, W, shift, x.device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(
                shifted_window_mask(T, H, W, self.window_size, shift),
                dtype=torch.float32, device=x.device)
        return self._masks[key]

    def _block_tokens(self, x: torch.Tensor, w: SWBlockWeights,
                      shift: Tuple[int, int]) -> torch.Tensor:
        B, T, H, W, C = x.shape
        win = self.window_size
        shifted = any(s > 0 for s in shift)
        h = torch.roll(x, (-shift[0], -shift[1]), dims=(2, 3)) if shifted else x
        tok = sw_block_tokens(window_partition(h, win).contiguous(), w,
                        self._mask(x, shift) if shifted else None,
                        (H // win[0]) * (W // win[1]))
        h = window_reverse(tok, win, B, T, H, W)
        return torch.roll(h, (shift[0], shift[1]), dims=(2, 3)) if shifted else h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        wh, ww = self.window_size
        if self.use_pallas and H % wh == 0 and W % ww == 0:
            x = x.contiguous()
            tokens = knobs.get("SW_KERNEL") == "tokens"
            pair = not tokens and knobs.get("SW_PAIR") == "1"
            shifts = [effective_window_shift((H, W), self.window_size, blk.shift_size)[1]
                      for blk in self.blocks]
            # a recorded gradient needs the live parameters (the kernels then
            # run through their autograd Functions); else the cached copies
            weights = [blk.live_weights() if torch.is_grad_enabled()
                       else blk.kernel_weights(x.device) for blk in self.blocks]
            i = 0
            while i < len(self.blocks):
                # a [no-shift, shift] pair; where H or W equals the window the
                # shift is clamped to 0 and the two blocks run on their own
                if (pair and i + 1 < len(self.blocks) and not any(shifts[i])
                        and any(shifts[i + 1])):
                    x = sw_block_pair(x, weights[i], weights[i + 1], shifts[i + 1])
                    i += 2
                    continue
                if tokens:
                    x = self._block_tokens(x, weights[i], shifts[i])
                else:
                    x = sw_block(x, weights[i], shifts[i])
                i += 1
            return x
        if self.use_pallas and x.is_cuda:
            raise NotImplementedError(
                f"EncoderLayer(use_pallas=True) on CUDA needs H, W divisible by "
                f"{self.window_size}, got {H}x{W}; use_pallas=False runs the module path")
        for blk in self.blocks:
            x = blk(x)
        return x


class DecoderLayer(nn.Module):
    """`depth` cross blocks with alternating shift (0 / window//2)
    (reference rstt_layers.py:577-662): forward(x [B, T, H, W, C],
    attn_kv [B, T2, H, W, C]) -> [B, T, H, W, C].  No deployed model
    builds it; plain PyTorch on every device."""

    def __init__(self, dim: int, depth: int, num_heads: int, num_frames: int,
                 window_size: Tuple[int, int] = (8, 8), mlp_ratio: float = 4.0):
        super().__init__()
        half = tuple(w // 2 for w in window_size)
        self.blocks = nn.ModuleList([
            SWTransformerBlock(dim, num_heads, num_frames, window_size,
                               (0, 0) if i % 2 == 0 else half, mlp_ratio, cross=True)
            for i in range(depth)])

    def forward(self, x: torch.Tensor, attn_kv: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, attn_kv)
        return x


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX package's conventions: fan-in normal conv and
    linear weights, zero biases, unit norms; then each module's own
    `init_extra` (bias tables, codebooks, zero-init heads, BN statistics)."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                normal_(m.weight, fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if hasattr(m, "init_extra"):
                m.init_extra(generator)
    return module
