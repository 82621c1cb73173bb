"""Dense pre-norm transformer layers for code-token prediction (PyTorch port).

Counterparts of the JAX package's ``nn/transformer.py`` in batch-first
``[B, N, C]`` layout, with torch.nn.MultiheadAttention's parameter names
(``in_proj_weight``, ``in_proj_bias``, ``out_proj``).  The attention core
runs through kernel K2 (``ops/dense_mha.py``) on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import layer_norm
from pgtformer_tpu_torch.ops.dense_mha import dense_mha


class MultiHeadSelfAttention(nn.Module):
    """Packed-projection multi-head attention.  When `q is k` (the deployed
    q = k = x + pos) both projections run as one matmul."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def init_extra(self, g: torch.Generator) -> None:
        C = self.embed_dim
        bound = (6.0 / (C + 3 * C)) ** 0.5      # xavier-uniform over (C, 3C)
        with torch.no_grad():
            self.in_proj_weight.copy_(
                (torch.rand(self.in_proj_weight.shape, generator=g) * 2 - 1) * bound)
            self.in_proj_bias.zero_()

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        C = self.embed_dim
        W, b = self.in_proj_weight, self.in_proj_bias
        if q is k:
            qk = F.linear(q, W[:2 * C], b[:2 * C])
            qp, kp = qk[..., :C], qk[..., C:]
        else:
            qp = F.linear(q, W[:C], b[:C])
            kp = F.linear(k, W[C:2 * C], b[C:2 * C])
        vp = F.linear(v, W[2 * C:], b[2 * C:])
        Nq, Nk = q.shape[1], k.shape[1]
        if q.is_cuda and not (Nq == Nk and Nq % 8 == 0):
            raise NotImplementedError(
                f"MultiHeadSelfAttention on CUDA needs Nq == Nk, N % 8 == 0; "
                f"got {Nq}, {Nk}")
        scale = (C // self.num_heads) ** -0.5
        out = dense_mha(qp, kp, vp, num_heads=self.num_heads, scale=scale)
        return self.out_proj(out)


class TransformerSALayer(nn.Module):
    """Pre-norm self-attention layer, q = k = LN(x) + pos, v = LN(x), with a
    GELU feed-forward (reference codeformer_arch.py:102-137)."""

    def __init__(self, embed_dim: int, nhead: int = 8, dim_mlp: int = 2048):
        super().__init__()
        self.norm1 = layer_norm(embed_dim)
        self.self_attn = MultiHeadSelfAttention(embed_dim, nhead)
        self.norm2 = layer_norm(embed_dim)
        self.linear1 = nn.Linear(embed_dim, dim_mlp)
        self.linear2 = nn.Linear(dim_mlp, embed_dim)

    def forward(self, tgt: torch.Tensor,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(tgt)
        qk = x if query_pos is None else x + query_pos
        tgt = tgt + self.self_attn(qk, qk, x)
        x = self.linear2(F.gelu(self.linear1(self.norm2(tgt))))
        return tgt + x
