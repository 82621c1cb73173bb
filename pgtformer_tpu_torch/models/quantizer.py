"""Residual-quantization bottleneck, inference surface (PyTorch port).

Counterpart of the JAX package's ``models/quantizer.py``.  Holds the
codebooks under the reference names (``codebooks.{i}.weight``,
``cluster_size_ema``, ``embed_ema``); codebook weights are
``[n_embed + 1, D]`` and the last row is the zero padding code.  Entry
points:

* :func:`compute_distances`, :func:`find_nearest_embedding`, :func:`embed`:
  the nearest-code search (kernel K5, ``ops/vq.py``, on a CUDA tensor
  unless ``EXACT_VQ=1``; the exact argmin on the CPU) and the lookup;
* :func:`ema_codebook_update`: one EMA step of a codebook's buffers, with
  dead-code restarts drawn from a ``torch.Generator`` (across the ranks of
  a group: the statistics summed, rank 0's restart vectors on every rank);
* :class:`RQBottleneck`: ``__call__`` -> (quantized with the straight-through
  sum, commitment loss, codes), ``quantize`` (with ``train=True`` each depth
  updates its codebook after taking its codes), ``embed_code``,
  ``embed_code_with_depth``, ``embed_partial_code``, ``get_soft_codes``.

Codebooks stay fp32 when the model is cast to bf16, as the JAX package
keeps them, and the bottleneck computes in fp32 under autocast too.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.nn.blocks import KeepFloat32
from pgtformer_tpu_torch.ops.vq import nearest_code
from pgtformer_tpu_torch.parallel import group as P


def compute_distances(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances to every (non-padding) code, in fp32.
    weight [n_embed + 1, D]; x [..., D] -> [..., n_embed]."""
    c32 = weight[:-1].float()
    x32 = x.float()
    x_sq = (x32 * x32).sum(-1, keepdim=True)
    c_sq = (c32 * c32).sum(-1)
    return x_sq + c_sq - 2.0 * (x32 @ c32.T)


def find_nearest_embedding(weight: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-code index (int64) per input vector x [..., D].

    On a CUDA tensor this is the fused lookup kernel, whose distance
    formulation can break a near-tie differently from the exact argmin, so
    codes are not bit-reproducible between the card and the CPU; knob
    ``EXACT_VQ=1`` forces ``argmin(compute_distances)`` on every device.
    On the CPU it is always the exact argmin."""
    if x.is_cuda and knobs.get("EXACT_VQ") != "1":
        idx = nearest_code(x.reshape(-1, x.shape[-1]).float().contiguous(),
                           weight[:-1].float())
        return idx.reshape(x.shape[:-1])
    return compute_distances(weight, x).argmin(dim=-1)


def embed(weight: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Codebook lookup (the padding index n_embed resolves to the zero row)."""
    return weight[idx]


@torch.no_grad()
def ema_codebook_update(weight: torch.Tensor, cluster_size_ema: torch.Tensor,
                        embed_ema: torch.Tensor, vectors: torch.Tensor, idxs: torch.Tensor, *,
                        decay: float, restart_unused_codes: bool,
                        generator: Optional[torch.Generator], eps: float = 1e-5,
                        group: Optional[P.Group] = None):
    """One EMA step of a codebook, in place on its buffers (weight
    [n_embed + 1, D], cluster_size_ema [n_embed], embed_ema [n_embed, D]);
    returns them.  The JAX package's ``ema_codebook_update`` (reference
    ``_update_buffers`` then ``_update_embedding``): EMA of each code's
    count and vector sum over `vectors` [..., D] assigned to `idxs` [...],
    codes used less than once restarted from the batch's vectors (a random
    permutation of them, tiled with uniform noise of 0.01/sqrt(D) when
    there are fewer vectors than codes, drawn from `generator`), then the
    Laplace-smoothed re-estimate of every code but the padding row.

    With a `group` (the JAX package's `axis_name`; reference
    tdcrqvae3_arch.py:157-171) each rank passes its own `vectors`: the
    counts and vector sums are summed over the ranks before the EMA, and
    every rank draws its restart candidates from its own vectors with its
    own generator (so the generators, seeded alike, stay in step), then
    takes rank 0's.  Every rank ends with the same buffers."""
    if restart_unused_codes and generator is None:
        raise ValueError("restart_unused_codes requires a generator")
    n_embed, dim = embed_ema.shape
    vecs = vectors.reshape(-1, dim).float()
    flat_idx = idxs.reshape(-1)
    n_vectors = vecs.shape[0]
    cluster_size = torch.bincount(flat_idx, minlength=n_embed)[:n_embed].float()
    vectors_sum = torch.zeros_like(embed_ema).index_add_(0, flat_idx, vecs)
    if group is not None:
        stats = P.all_reduce_(torch.cat([cluster_size[:, None], vectors_sum], dim=1), group)
        cluster_size, vectors_sum = stats[:, 0], stats[:, 1:]
    cluster_size_ema.mul_(decay).add_(cluster_size * (1 - decay))
    embed_ema.mul_(decay).add_(vectors_sum * (1 - decay))

    if restart_unused_codes:
        cands = vecs
        if n_vectors < n_embed:
            cands = cands.repeat(-(-n_embed // n_vectors), 1)
            noise = torch.rand(cands.shape, generator=generator, device=cands.device)
            cands = cands + noise * (0.01 / math.sqrt(dim))
        perm = torch.randperm(cands.shape[0], generator=generator, device=cands.device)
        restart_vecs = cands[perm[:n_embed]]
        if group is not None:
            P.broadcast_(restart_vecs, group)
        usage = (cluster_size_ema >= 1.0).float()
        embed_ema.copy_(embed_ema * usage[:, None] + restart_vecs * (1 - usage[:, None]))
        cluster_size_ema.copy_(cluster_size_ema * usage + (1 - usage))

    n = cluster_size_ema.sum()
    normalized = n * (cluster_size_ema + eps) / (n + n_embed * eps)
    weight[:-1] = (embed_ema / normalized[:, None]).to(weight.dtype)
    return weight, cluster_size_ema, embed_ema


class VQEmbedding(KeepFloat32):
    """One codebook: `weight` [n_embed + 1, D] plus the EMA buffers, kept
    fp32 under a dtype cast."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n_embed + 1, embed_dim),
                                   requires_grad=False)
        self.register_buffer("cluster_size_ema", torch.zeros(n_embed))
        self.register_buffer("embed_ema", torch.zeros(n_embed, embed_dim))

    def init_extra(self, g: torch.Generator) -> None:
        with torch.no_grad():
            w = torch.randn(self.weight.shape, generator=g)
            w[-1] = 0.0
            self.weight.copy_(w)
            self.embed_ema.copy_(w[:-1])
            self.cluster_size_ema.zero_()

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return embed(self.weight, idx)


class RQBottleneck(nn.Module):
    """Residual quantization over `code_shape[-1]` depths.  `decay` (one per
    depth or shared) and `restart_unused_codes` drive the EMA update of
    ``quantize(train=True)``; with a `group` that update runs across its
    ranks (:func:`ema_codebook_update`)."""

    def __init__(self, latent_shape: Tuple[int, int, int],
                 code_shape: Tuple[int, int, int], n_embed=1024, decay=0.99,
                 shared_codebook: bool = False, restart_unused_codes: bool = True,
                 group: Optional[P.Group] = None):
        super().__init__()
        self.group = group
        if any(l % c for l, c in zip(latent_shape[:2], code_shape[:2])):
            raise ValueError("incompatible code shape or latent shape")
        self.latent_shape = tuple(latent_shape)
        self.code_shape = tuple(code_shape)
        depth = code_shape[-1]
        n_list = (tuple(n_embed) if isinstance(n_embed, (list, tuple))
                  else (n_embed,) * depth)
        self.shape_divisor = (latent_shape[0] // code_shape[0],
                              latent_shape[1] // code_shape[1])
        self.embed_dim = self.shape_divisor[0] * self.shape_divisor[1] * latent_shape[2]
        self.decay_list = (tuple(decay) if isinstance(decay, (list, tuple))
                           else (decay,) * depth)
        self.restart_unused_codes = restart_unused_codes
        self.shared_codebook = shared_codebook
        n_books = 1 if shared_codebook else depth
        self.codebooks = nn.ModuleList(
            [VQEmbedding(n_list[i], self.embed_dim) for i in range(n_books)])

    def _book(self, i: int) -> VQEmbedding:
        return self.codebooks[0 if self.shared_codebook else i]

    def to_code_shape(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, D = x.shape
        rH, rW = self.shape_divisor
        if (rH, rW) == (1, 1):
            return x
        x = x.reshape(B, H // rH, rH, W // rW, rW, D).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, H // rH, W // rW, rH * rW * D)

    def to_latent_shape(self, x: torch.Tensor) -> torch.Tensor:
        B, h, w, _ = x.shape
        rH, rW = self.shape_divisor
        if (rH, rW) == (1, 1):
            return x
        D = self.latent_shape[2]
        x = x.reshape(B, h, w, rH, rW, D).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, h * rH, w * rW, D)

    def quantize(self, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None):
        """Sequential residual quantization of x [B, h, w, embed_dim] ->
        (list of the aggregated quantized latents per depth (fp32),
        codes [B, h, w, depth] int64).  With `train`, each depth finds and
        embeds its codes with the codebook as it stands, then applies its EMA
        update to the codebook's buffers (restarts drawn from `generator`);
        the returned latents are those from before the update."""
        residual = x.detach().float()
        aggregated = torch.zeros_like(residual)
        quant_list: List[torch.Tensor] = []
        code_list: List[torch.Tensor] = []
        for i in range(self.code_shape[-1]):
            book = self._book(i)
            weight = book.weight
            idx = find_nearest_embedding(weight, residual)
            quant = embed(weight, idx).float()      # a copy: the update below leaves it
            if train:
                ema_codebook_update(weight, book.cluster_size_ema, book.embed_ema, residual,
                                    idx, decay=self.decay_list[i],
                                    restart_unused_codes=self.restart_unused_codes,
                                    generator=generator, group=self.group)
            residual = residual - quant
            aggregated = aggregated + quant
            quant_list.append(aggregated)
            code_list.append(idx[..., None])
        return quant_list, torch.cat(code_list, dim=-1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x [B, H, W, D] latents -> (quantized latents with the
        straight-through sum x + (q - x), commitment loss, codes).  With
        `train`, the codebooks take their EMA step (:meth:`quantize`).  The
        search, the update and the loss run in fp32, autocast or not."""
        with torch.autocast(x.device.type, enabled=False):
            xr = self.to_code_shape(x)
            quant_list, codes = self.quantize(xr, train, generator)
            commitment = self.compute_commitment_loss(xr, quant_list)
            q = self.to_latent_shape(quant_list[-1].to(x.dtype))
            q = x + (q - x).detach()
        return q, commitment, codes

    def compute_commitment_loss(self, x: torch.Tensor,
                                quant_list: List[torch.Tensor]) -> torch.Tensor:
        losses = [((x.float() - q.detach()) ** 2).mean() for q in quant_list]
        return torch.stack(losses).mean()

    def embed_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, h, w, depth] -> latents [B, H, W, D] (sum over depth)."""
        total = None
        for i in range(self.code_shape[-1]):
            e = self._book(i)(codes[..., i])
            total = e if total is None else total + e
        return self.to_latent_shape(total)

    def embed_code_with_depth(self, codes: torch.Tensor, to_latent: bool = False):
        """Per-depth embeddings [B, h, w, depth, D] (second value None, as
        the JAX package returns it)."""
        outs = []
        for i in range(self.code_shape[-1]):
            e = self._book(i)(codes[..., i])
            if to_latent:
                e = self.to_latent_shape(e)
            outs.append(e[..., None, :])
        return torch.cat(outs, dim=-2), None

    def embed_partial_code(self, codes: torch.Tensor, code_idx: int,
                           decode_type: str = "select") -> torch.Tensor:
        """Latents from depth `code_idx` alone ("select") or from depths
        0..code_idx ("add")."""
        embeds = [self._book(i)(codes[..., i]) for i in range(self.code_shape[-1])]
        if decode_type == "select":
            out = embeds[code_idx]
        elif decode_type == "add":
            out = sum(embeds[:code_idx + 1])
        else:
            raise NotImplementedError(decode_type)
        return self.to_latent_shape(out)

    def get_soft_codes(self, x: torch.Tensor, temp: float = 1.0, stochastic: bool = False,
                       generator: Optional[torch.Generator] = None):
        """Soft codes softmax(-dist / temp) [B, h, w, depth, n_embed] and the
        hard codes that drive the residual: the exact argmin, or with
        `stochastic` a sample from the soft distribution drawn with
        `generator` (on x's device)."""
        with torch.autocast(x.device.type, enabled=False):
            return self._soft_codes(x, temp, stochastic, generator)

    def _soft_codes(self, x, temp, stochastic, generator):
        residual = self.to_code_shape(x).detach().float()
        soft_list, code_list = [], []
        for i in range(self.code_shape[-1]):
            weight = self._book(i).weight
            dist = compute_distances(weight, residual)
            soft = torch.softmax(-dist / temp, dim=-1)
            if stochastic:
                flat = soft.reshape(-1, soft.shape[-1]) + 1e-20
                code = torch.multinomial(flat, 1, generator=generator)
                code = code.reshape(soft.shape[:-1])
            else:
                code = dist.argmin(dim=-1)
            residual = residual - embed(weight, code).float()
            code_list.append(code[..., None])
            soft_list.append(soft[..., None, :])
        return torch.cat(soft_list, dim=-2), torch.cat(code_list, dim=-1)
