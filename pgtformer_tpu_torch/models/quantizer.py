"""Residual-quantization bottleneck, serving surface (PyTorch port).

Holds the codebook buffers under the reference names
(``codebooks.{i}.weight``, ``cluster_size_ema``, ``embed_ema``) and turns
code indices back into latents (:meth:`RQBottleneck.embed_code`).  The
nearest-code search and the EMA update are not part of this port yet.
Codebook weights are ``[n_embed + 1, D]``; the last row is the zero
padding code.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class VQEmbedding(nn.Module):
    """One codebook: `weight` [n_embed + 1, D] plus the EMA buffers."""

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
        return self.weight[idx]


class RQBottleneck(nn.Module):
    def __init__(self, latent_shape: Tuple[int, int, int],
                 code_shape: Tuple[int, int, int], n_embed=1024,
                 shared_codebook: bool = False):
        super().__init__()
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

    def embed_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, h, w, depth] -> latents [B, H, W, D] (sum over depth)."""
        total = None
        for i in range(self.code_shape[-1]):
            e = self._book(i)(codes[..., i])
            total = e if total is None else total + e
        return self.to_latent_shape(total)
