"""The VQGAN family (PyTorch port): VQAutoEncoder, its quantizers, the
PatchGAN discriminator.

Counterpart of the JAX package's ``models/vqgan.py`` (reference
archs/vqgan_arch.py, the CodeFormer-lineage image autoencoder) on
channels-last frames.  The encoder and generator are indexed block lists
(``blocks.{i}``, their resampling convs ``blocks.{i}.conv``), as CodeFormer
taps the encoder and fuses into the generator by block index; the
discriminator keeps the reference's ``main.{i}`` names.

JAX computes the quantizer's distances and the single-head attention of
:class:`AttnBlock2D` with XLA, not with a Pallas kernel, so both are plain
PyTorch here on every device: the quantizer needs the whole distance
matrix for its scores and mean distance (kernel K5's ``|c|^2 - 2x.c``
would also round otherwise), and the attention keeps its logits in fp32
as JAX does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import (
    Downsample, GroupNorm, KeepFloat32, ResnetBlock, Upsample, conv_nhwc, init_weights)
from pgtformer_tpu_torch.parallel import group as P
from pgtformer_tpu_torch.registry import ARCH_REGISTRY


class _Float32Embedding(KeepFloat32, nn.Embedding):
    """A codebook whose weight stays fp32 under a dtype cast, as flax keeps
    it."""


class VectorQuantizer(nn.Module):
    """Nearest-neighbour VQ with commitment loss and usage statistics
    (reference vqgan_arch.py:24-98).  The codebook ``embedding.weight``
    [codebook_size, emb_dim] stays fp32 under a dtype cast.

    forward(z [N, H, W, C]) -> (z + (z_q - z) detached, loss, stats): the
    squared distances |z|^2 + |e|^2 - 2 z.e in fp32, the first argmin, the
    loss mean((z_q - sg(z))^2) * beta + mean((sg(z_q) - z)^2), and stats
    ``perplexity``, ``min_encoding_indices``, ``min_encoding_scores``
    (exp(-d_min / 10)) and ``mean_distance``."""

    def __init__(self, codebook_size: int, emb_dim: int, beta: float = 0.25):
        super().__init__()
        self.codebook_size = codebook_size
        self.emb_dim = emb_dim
        self.beta = beta
        self.embedding = _Float32Embedding(codebook_size, emb_dim)

    def init_extra(self, g: torch.Generator) -> None:
        n = self.codebook_size
        with torch.no_grad():
            w = self.embedding.weight
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) / n)

    def forward(self, z: torch.Tensor):
        e = self.embedding.weight.float()
        zf = z.reshape(-1, self.emb_dim).float()
        d = (zf * zf).sum(1, keepdim=True) + (e * e).sum(1) - 2.0 * (zf @ e.T)
        idx = d.argmin(dim=1)           # the first minimum, as jnp.argmin
        d_min = d.min(dim=1).values
        z_q = e[idx].reshape(z.shape)
        zf = z.float()
        loss = (((z_q.detach() - zf) ** 2).mean()
                + self.beta * ((z_q - zf.detach()) ** 2).mean())
        z_q = z + (z_q.to(z.dtype) - z).detach()
        e_mean = torch.bincount(idx, minlength=self.codebook_size).float() / idx.numel()
        stats = {"perplexity": torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum()),
                 "min_encoding_indices": idx,
                 "min_encoding_scores": torch.exp(-d_min / 10.0),
                 "mean_distance": d.mean()}
        return z_q, loss, stats

    def get_codebook_feat(self, indices: torch.Tensor,
                          shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
        """indices [...] -> codebook rows, reshaped to the channels-last
        `shape` (N, H, W, C) when given (fp32)."""
        z_q = self.embedding.weight[indices.reshape(-1)]
        return z_q.reshape(shape) if shape is not None else z_q


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in (0, 1), fp32,
    drawn from `generator` on `device` (where the JAX package draws
    ``jax.random.gumbel`` from the ``gumbel`` rng stream)."""
    if generator is None:
        raise ValueError("GumbelQuantizer needs a generator for its noise")
    u = torch.rand(shape, generator=generator, device=device)      # [0, 1)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


class GumbelQuantizer(nn.Module):
    """Gumbel-softmax quantizer (reference vqgan_arch.py:101-128): a 1x1
    conv ``proj`` to codebook logits, noise from :func:`gumbel_noise`,
    softmax at `temp_init`; hard (one-hot with the soft gradient) unless
    `train` with `straight_through` off; the codebook ``embed.weight``
    stays fp32.  forward(z, train, generator) -> (z_q, KL term,
    {"min_encoding_indices"})."""

    def __init__(self, codebook_size: int, emb_dim: int, num_hiddens: int,
                 straight_through: bool = False, kl_weight: float = 5e-4,
                 temp_init: float = 1.0):
        super().__init__()
        self.codebook_size = codebook_size
        self.straight_through = straight_through
        self.kl_weight = kl_weight
        self.temp_init = temp_init
        self.proj = nn.Conv2d(num_hiddens, codebook_size, 1)
        self.embed = _Float32Embedding(codebook_size, emb_dim)

    def init_extra(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.embed.weight.copy_(torch.randn(self.embed.weight.shape, generator=g))

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        hard = self.straight_through if train else True
        logits = conv_nhwc(self.proj, z)
        noise = gumbel_noise(logits.shape, generator, logits.device)
        y_soft = torch.softmax((logits.float() + noise) / self.temp_init, dim=-1)
        idx = y_soft.argmax(dim=-1)
        if hard:
            y_hard = F.one_hot(idx, self.codebook_size).to(y_soft.dtype)
            y = y_hard + y_soft - y_soft.detach()
        else:
            y = y_soft
        z_q = torch.einsum("bhwn,nd->bhwd", y, self.embed.weight.float()).to(z.dtype)
        qy = torch.softmax(logits, dim=-1)
        diff = self.kl_weight * (qy * torch.log(qy * self.codebook_size + 1e-10)).sum(-1).mean()
        return z_q, diff, {"min_encoding_indices": idx}


class ResBlock2D(ResnetBlock):
    """GroupNorm/SiLU/conv resblock whose 1x1 shortcut is ``conv_out``
    (reference vqgan_arch.py:154-177)."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__(in_channels, out_channels, shortcut_name="conv_out")


class AttnBlock2D(nn.Module):
    """Single-head self-attention over the H*W tokens of [N, H, W, C]
    (reference vqgan_arch.py:180-241): GroupNorm, 1x1 q/k/v, fp32 logits
    scaled by C^-1/2, softmax rounded to x's dtype, P.V accumulated in fp32
    and rounded once, 1x1 ``proj_out``, residual."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        h = self.norm(x)
        tok = lambda conv: conv_nhwc(conv, h).reshape(B, H * W, C)
        q, k, v = tok(self.q), tok(self.k), tok(self.v)
        # bf16 products are exact in fp32: these are JAX's fp32-accumulated logits
        attn = torch.matmul(q.float(), k.float().transpose(1, 2)).mul_(C ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).reshape(B, H, W, C)
        return conv_nhwc(self.proj_out, out, residual=x)


class _SeqTower(nn.Module):
    """Indexed block list (``blocks.{i}``) shared by encoder and generator.

    `specs` is a tuple of (kind, arg): ``conv`` (3x3 to arg channels),
    ``res`` (:class:`ResBlock2D` to arg), ``attn``, ``down`` (stride-2 3x3
    after a (0,1) pad), ``up`` (nearest 2x, then 3x3), ``norm``, ``silu``.
    forward(x, taps, hooks): `taps` collects the activations after the
    listed block indices (returned with the output when asked for);
    `hooks` maps a block index to fn(x) -> x applied after that block
    (CodeFormer's fuse-after-block-i).  A ``norm`` followed by ``silu`` runs
    as one call of the norm, unless the norm's output is tapped or hooked."""

    def __init__(self, specs: Tuple[Tuple[str, Any], ...], in_channels: int):
        super().__init__()
        self.specs = tuple(specs)
        blocks: List[nn.Module] = []
        ch = in_channels
        for kind, arg in self.specs:
            if kind == "conv":
                blocks.append(nn.Conv2d(ch, arg, 3, padding=1))
                ch = arg
            elif kind == "res":
                blocks.append(ResBlock2D(ch, arg))
                ch = arg
            elif kind == "attn":
                blocks.append(AttnBlock2D(ch))
            elif kind in ("down", "up"):
                if arg != ch:
                    raise ValueError(f"{kind} block from {ch} to {arg} channels")
                # nearest-up then conv3x3 as is, as the JAX package's VQGAN runs it
                blocks.append(Downsample(ch) if kind == "down" else Upsample(ch, subpixel=False))
            elif kind == "norm":
                blocks.append(GroupNorm(ch))
            elif kind == "silu":
                blocks.append(nn.SiLU())
            else:
                raise ValueError(kind)
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = ch

    def forward(self, x: torch.Tensor, taps: Tuple[int, ...] = (), hooks=None):
        tapped = {}
        silu_done = False
        for i, ((kind, _), block) in enumerate(zip(self.specs, self.blocks)):
            if silu_done:           # the norm before this SiLU applied it
                silu_done = False
            elif (kind == "norm" and self.specs[i + 1:i + 2] == (("silu", None),)
                  and i not in taps and not (hooks and i in hooks)):
                x = block(x, silu=True)
                silu_done = True
            else:
                x = conv_nhwc(block, x) if kind == "conv" else block(x)
            if i in taps:
                tapped[i] = x
            if hooks and i in hooks:
                x = hooks[i](x)
        return (x, tapped) if taps else x


def encoder_specs(in_channels, nf, emb_dim, ch_mult, num_res_blocks,
                  resolution, attn_resolutions, last_silu=False):
    """Block layout of reference vqgan_arch.Encoder (:243-289)."""
    specs: List[Tuple[str, Any]] = [("conv", nf)]
    curr_res = resolution
    ch = nf
    for i in range(len(ch_mult)):
        out_ch = nf * ch_mult[i]
        for _ in range(num_res_blocks):
            specs.append(("res", out_ch))
            ch = out_ch
            if curr_res in attn_resolutions:
                specs.append(("attn", None))
        if i != len(ch_mult) - 1:
            specs.append(("down", ch))
            curr_res //= 2
    specs += [("res", ch), ("attn", None), ("res", ch), ("norm", None)]
    if last_silu:
        specs.append(("silu", None))
    specs.append(("conv", emb_dim))
    return tuple(specs)


def generator_specs(nf, emb_dim, ch_mult, res_blocks, img_size,
                    attn_resolutions, last_silu=False, out_channels=3):
    """Block layout of reference vqgan_arch.Generator (:292-341)."""
    ch = nf * ch_mult[-1]
    curr_res = img_size // 2 ** (len(ch_mult) - 1)
    specs: List[Tuple[str, Any]] = [("conv", ch), ("res", ch), ("attn", None),
                                    ("res", ch)]
    for i in reversed(range(len(ch_mult))):
        out_ch = nf * ch_mult[i]
        for _ in range(res_blocks):
            specs.append(("res", out_ch))
            ch = out_ch
            if curr_res in attn_resolutions:
                specs.append(("attn", None))
        if i != 0:
            specs.append(("up", ch))
            curr_res *= 2
    specs.append(("norm", None))
    if last_silu:
        specs.append(("silu", None))
    specs.append(("conv", out_channels))
    return tuple(specs)


@ARCH_REGISTRY.register()
class VQAutoEncoder(nn.Module):
    """Classic VQGAN autoencoder (reference vqgan_arch.py:345-411).

    forward(x [N, H, W, 3], code_only, generator) -> (recon [N, H, W, 3],
    codebook loss, stats), or the quantized latents in place of recon with
    `code_only`.  The ``gumbel`` quantizer draws its noise from the
    forward's `generator`.  With the constructor's `generator`, every
    weight is initialized from it."""

    def __init__(self, img_size: int = 512, nf: int = 64,
                 ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8), quantizer: str = "nearest",
                 res_blocks: int = 2, attn_resolutions: Tuple[int, ...] = (16,),
                 codebook_size: int = 1024, emb_dim: int = 256, beta: float = 0.25,
                 gumbel_straight_through: bool = False, gumbel_kl_weight: float = 1e-8,
                 last_silu: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.quantizer = quantizer
        self.encoder = _SeqTower(encoder_specs(3, nf, emb_dim, ch_mult, res_blocks, img_size,
                                              attn_resolutions, last_silu), 3)
        if quantizer == "nearest":
            self.quantize = VectorQuantizer(codebook_size, emb_dim, beta)
        elif quantizer == "gumbel":
            self.quantize = GumbelQuantizer(codebook_size, emb_dim, emb_dim,
                                            gumbel_straight_through, gumbel_kl_weight)
        else:
            raise ValueError(f"quantizer {quantizer!r} (choices: nearest, gumbel)")
        self.generator = _SeqTower(generator_specs(nf, emb_dim, ch_mult, res_blocks, img_size,
                                                  attn_resolutions, last_silu), emb_dim)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor, code_only: bool = False,
                generator: Optional[torch.Generator] = None):
        z = self.encoder(x)
        if self.quantizer == "gumbel":
            quant, loss, stats = self.quantize(z, generator=generator)
        else:
            quant, loss, stats = self.quantize(z)
        if code_only:
            return quant, loss, stats
        return self.generator(quant), loss, stats


class BatchNorm(KeepFloat32):
    """flax's ``nn.BatchNorm`` over [N, H, W, C] with torch's names
    (``weight``, ``bias``, ``running_mean``, ``running_var``; no
    ``num_batches_tracked``).

    In train mode it normalizes with the batch's mean and *biased* variance
    (E[x^2] - mean^2, in fp32) and, unless `update_stats` is off, moves the
    running statistics by running = 0.9 * running + 0.1 * batch, also with
    the biased variance (``torch.nn.BatchNorm2d`` would store the unbiased
    one).  In eval mode it normalizes with the running statistics.  The
    affine and the statistics stay fp32; the output has x's dtype.

    With a `group` (flax's ``axis_name``), the batch mean and mean of squares
    are the means over the ranks' batches (equal per rank), summed with a
    gradient (``parallel.sync_sum``): synced batch statistics, which
    ``torch.nn.SyncBatchNorm`` would give only on CUDA tensors."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.group = None
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 1, 2))
            mean_sq = (xf * xf).mean(dim=(0, 1, 2))
            if self.group is not None:
                mean, mean_sq = P.sync_sum(torch.stack([mean, mean_sq]),
                                           self.group) / self.group.world
            var = (mean_sq - mean * mean).clamp_min(0.0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_(mean * (1.0 - m))
                    self.running_var.mul_(m).add_(var * (1.0 - m))
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (self.weight * torch.rsqrt(var + self.eps)) + self.bias
        return y.to(x.dtype)


@ARCH_REGISTRY.register()
class VQGANDiscriminator(nn.Module):
    """PatchGAN: a 4x4 stride-2 conv with LeakyReLU(0.2), `n_layers - 1`
    stride-2 conv + BN + LeakyReLU stages, a stride-1 one, then a stride-1
    conv to one logit per patch; padding 1 everywhere.

    forward(x [N, H, W, nc], train, update_stats) -> logits [N, h, w, 1].
    In train mode every BatchNorm uses the batch's statistics and (with
    `update_stats`) advances its running ones, so a training step that runs
    the discriminator several times threads them from pass to pass, as the
    JAX trainers thread `batch_stats`.  :meth:`set_group` syncs the
    BatchNorms' batch statistics over the ranks of a group."""

    def __init__(self, nc: int = 3, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        layers = [nn.Conv2d(nc, ndf, 4, stride=2, padding=1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=2, padding=1, bias=False),
                       BatchNorm(ndf * mult), nn.LeakyReLU(0.2)]
        prev, mult = mult, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, stride=1, padding=1, bias=False),
                   BatchNorm(ndf * mult), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * mult, 1, 4, stride=1, padding=1)]
        self.main = nn.Sequential(*layers)

    def set_group(self, group) -> "VQGANDiscriminator":
        """Sync every BatchNorm's batch statistics over `group` (None: each
        process its own); the JAX package's ``clone(axis_name=...)``."""
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.group = group
        return self

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        for layer in self.main:
            if isinstance(layer, nn.Conv2d):
                x = conv_nhwc(layer, x)
            elif isinstance(layer, BatchNorm):
                x = layer(x, train=train, update_stats=update_stats)
            else:
                x = F.leaky_relu(x, 0.2)
        return x
