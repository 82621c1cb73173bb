"""Dense pre-norm transformer layers for code-token prediction (PyTorch port).

Counterparts of the JAX package's ``nn/transformer.py`` in batch-first
``[B, N, C]`` layout, with torch.nn.MultiheadAttention's parameter names
(``in_proj_weight``, ``in_proj_bias``, ``out_proj``).  With ``use_pallas``
on CUDA the attention core runs through ``ops/dense_mha.py``: kernel K6
(heads-minor views of the packed projections, the default) or K2
(``mha_layout="bhnd"``), through its autograd Function when a gradient is
recorded; without it, the plain softmax attention (JAX's XLA path).  Also
here: CodeFormer's cross-attention layer (:class:`TransformerCALayer`, the
same attention with q != k) and its sinusoidal 2-D position embedding
(:class:`PositionEmbeddingSine`, numpy constants as in JAX).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.nn.blocks import layer_norm
from pgtformer_tpu_torch.ops.dense_mha import dense_mha, dense_mha_ref_bnhd


class MultiHeadSelfAttention(nn.Module):
    """Packed-projection multi-head attention.  When `q is k` (the deployed
    q = k = x + pos) both projections run as one matmul.

    `use_pallas` (JAX's name and default): True runs the attention core
    through ``ops/dense_mha.py`` where Nq == Nk and N % 8 == 0 (the kernel
    on CUDA, its plain version on the CPU; other geometry raises on CUDA,
    where JAX takes its XLA path silently, and takes the module path on the
    CPU); False runs the plain softmax attention of JAX's XLA path on any
    device.

    `mha_layout` picks the kernel's evaluation plan: "bnhd" hands it
    [B, N, H, D] views of the packed projections and gets the packed output
    back; "bhnd" hands it their [B, H, N, D] transposed views (no copy) and
    transposes the output back (one copy)."""

    def __init__(self, embed_dim: int, num_heads: int, mha_layout: str = "bnhd",
                 use_pallas: bool = False):
        super().__init__()
        if mha_layout not in ("bnhd", "bhnd"):
            raise ValueError(f"mha_layout {mha_layout!r} (choices: bnhd, bhnd)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mha_layout = mha_layout
        self.use_pallas = use_pallas
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
        kernel = self.use_pallas
        if kernel and not (Nq == Nk and Nq % 8 == 0):
            if q.is_cuda:
                raise NotImplementedError(
                    f"MultiHeadSelfAttention(use_pallas=True) on CUDA needs Nq == Nk, "
                    f"N % 8 == 0; got {Nq}, {Nk}; use_pallas=False runs the module path")
            kernel = False
        B, h, hd = q.shape[0], self.num_heads, C // self.num_heads
        heads = lambda a: a.reshape(B, a.shape[1], h, hd)
        if not kernel:
            out = dense_mha_ref_bnhd(heads(qp), heads(kp), heads(vp), hd ** -0.5)
        elif self.mha_layout == "bnhd":
            out = dense_mha(heads(qp), heads(kp), heads(vp), scale=hd ** -0.5, layout="bnhd")
        else:
            t = lambda a: heads(a).transpose(1, 2)
            out = dense_mha(t(qp), t(kp), t(vp), scale=hd ** -0.5, layout="bhnd").transpose(1, 2)
        return self.out_proj(out.reshape(B, Nq, C))


class TransformerSALayer(nn.Module):
    """Pre-norm self-attention layer, q = k = LN(x) + pos, v = LN(x), with a
    GELU feed-forward (reference codeformer_arch.py:102-137)."""

    def __init__(self, embed_dim: int, nhead: int = 8, dim_mlp: int = 2048,
                 mha_layout: str = "bnhd", use_pallas: bool = False):
        super().__init__()
        self.norm1 = layer_norm(embed_dim)
        self.self_attn = MultiHeadSelfAttention(embed_dim, nhead, mha_layout, use_pallas)
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


@functools.lru_cache(maxsize=None)
def _sine_table(H: int, W: int, num_pos_feats: int, temperature: float, normalize: bool,
                scale: float) -> np.ndarray:
    """[H, W, 2 * num_pos_feats] fp32: the y embedding, then the x one."""
    y_embed = np.cumsum(np.ones((H, W), np.float32), axis=0)
    x_embed = np.cumsum(np.ones((H, W), np.float32), axis=1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1).reshape(H, W, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1).reshape(H, W, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


class PositionEmbeddingSine(nn.Module):
    """Sinusoidal 2-D position embedding (reference codeformer_arch.py:49-89;
    defined but unused there): [N, H, W, C] -> [N, H, W, 2 * num_pos_feats]
    in x's dtype, on x's device."""

    def __init__(self, num_pos_feats: int = 64, temperature: float = 10000.0,
                 normalize: bool = False, scale: Optional[float] = None):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.normalize = normalize
        self.scale = scale or 2 * np.pi

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, H, W, _ = x.shape
        pos = _sine_table(H, W, self.num_pos_feats, self.temperature, self.normalize,
                          self.scale)
        pos = torch.as_tensor(pos, device=x.device).to(x.dtype)
        return pos.expand(N, *pos.shape)


class TransformerCALayer(nn.Module):
    """Pre-norm cross-attention layer with a weighted residual (reference
    codeformer_arch.py:141-183; unused by the deployed model): one LN
    ``norm1`` for both inputs, q = LN(a) + pos, k = LN(b) + pos, v = LN(b),
    tgt = a + w * attention, then the GELU feed-forward.  The attention is
    :class:`MultiHeadSelfAttention` with q != k, on its module path on every
    device (JAX's layer passes no ``use_pallas`` either)."""

    def __init__(self, embed_dim: int, nhead: int = 8, dim_mlp: int = 2048,
                 mha_layout: str = "bnhd"):
        super().__init__()
        self.norm1 = layer_norm(embed_dim)
        self.self_attn = MultiHeadSelfAttention(embed_dim, nhead, mha_layout)
        self.norm2 = layer_norm(embed_dim)
        self.linear1 = nn.Linear(embed_dim, dim_mlp)
        self.linear2 = nn.Linear(dim_mlp, embed_dim)

    def forward(self, tgta: torch.Tensor, tgtb: torch.Tensor, w: float = 1.0,
                query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        a, b = self.norm1(tgta), self.norm1(tgtb)
        q = a if query_pos is None else a + query_pos
        k = b if query_pos is None else b + query_pos
        tgt = tgta + self.self_attn(q, k, b) * w
        x = self.linear2(F.gelu(self.linear1(self.norm2(tgt))))
        return tgt + x
