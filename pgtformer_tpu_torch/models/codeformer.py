"""CodeFormer, the single-image baseline (PyTorch port).

Counterpart of the JAX package's ``models/codeformer.py`` (reference
archs/codeformer_arch.py:200-366): the VQAutoEncoder towers, a learned
position embedding, 9 pre-norm ``TransformerSALayer``s over the 16x16 latent
tokens (kernel K6 on a CUDA tensor, K2 under ``mha_layout="bhnd"``), code
prediction, codebook lookup and the non-temporal Fuse-SFT skips at fixed
encoder / generator block indices.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.models.vqgan import (
    ResBlock2D, VectorQuantizer, _SeqTower, encoder_specs, generator_specs)
from pgtformer_tpu_torch.nn.blocks import conv_nhwc, init_weights, layer_norm
from pgtformer_tpu_torch.nn.transformer import TransformerSALayer
from pgtformer_tpu_torch.ops.image import adaptive_instance_normalization
from pgtformer_tpu_torch.registry import ARCH_REGISTRY
from pgtformer_tpu_torch.utils import profiling
from pgtformer_tpu_torch.utils.profiling import span


class FuseSftBlock2D(nn.Module):
    """Non-temporal Fuse-SFT (reference codeformer_arch.py:200-226):
    dec + w * (dec * scale + shift), scale and shift from a resblock over
    [enc | dec]."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.encode_enc = ResBlock2D(2 * in_ch, out_ch)
        self.scale = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.shift = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, padding=1), nn.LeakyReLU(0.2),
                                   nn.Conv2d(out_ch, out_ch, 3, padding=1))

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor,
                w: float = 1.0) -> torch.Tensor:
        feat = self.encode_enc(torch.cat([enc_feat, dec_feat], dim=-1))
        head = lambda s: conv_nhwc(s[2], F.leaky_relu(conv_nhwc(s[0], feat), 0.2))
        return dec_feat + w * (dec_feat * head(self.scale) + head(self.shift))


@ARCH_REGISTRY.register()
class CodeFormer(nn.Module):
    """Single-image CodeFormer (reference codeformer_arch.py:230-366).

    forward(x [N, H, W, 3], w, detach_16, code_only, adain) -> (out
    [N, H, W, 3], logits [N, hw, codebook_size], lq_feat [N, h, w, emb_dim]),
    or (logits, lq_feat) with `code_only`.  With w > 0 the fuse blocks run
    after the generator blocks of ``FUSE_GENERATOR_BLOCK`` on the encoder
    features tapped after the blocks of ``FUSE_ENCODER_BLOCK`` (gradient
    stopped); class attributes, as in JAX, so a subclass can relabel them.
    With the constructor's `generator` every weight is initialized from it;
    `mha_layout` is the transformer's attention plan (nn/transformer.py).
    `use_pallas` is the transformer layers' plan (False by default): the
    JAX CodeFormer has no such switch and runs its attention on the XLA
    path, which the module path ports; True runs K6 (or K2) on CUDA.
    A forward is traced (utils/profiling.py) as the spans ``pgt.encode``,
    ``pgt.transformer`` and ``pgt.decode``, inside a ``pgt.call`` of its own
    where no span is open."""

    # encoder tap / generator fuse block indices (reference :278-280)
    FUSE_ENCODER_BLOCK = {"512": 2, "256": 5, "128": 8, "64": 11, "32": 14, "16": 18}
    FUSE_GENERATOR_BLOCK = {"16": 6, "32": 9, "64": 12, "128": 15, "256": 18, "512": 21}
    CHANNELS = {"16": 512, "32": 256, "64": 256, "128": 128, "256": 128, "512": 64}

    def __init__(self, dim_embd: int = 512, n_head: int = 8, n_layers: int = 9,
                 codebook_size: int = 1024, latent_size: int = 256,
                 connect_list: Tuple[str, ...] = ("32", "64", "128", "256"),
                 img_size: int = 512, nf: int = 64, ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4, 8),
                 quantizer: str = "nearest", res_blocks: int = 2,
                 attn_resolutions: Tuple[int, ...] = (16,), emb_dim: int = 256, w: float = 0.0,
                 detach_16: bool = True, adain: bool = False, last_silu: bool = False,
                 generator: Optional[torch.Generator] = None, mha_layout: str = "bnhd",
                 use_pallas: bool = False):
        super().__init__()
        if quantizer != "nearest":
            raise ValueError(f"quantizer {quantizer!r}: CodeFormer takes 'nearest'")
        self.w = w
        self.adain = adain
        self.emb_dim = emb_dim
        self.connect_list = tuple(connect_list)
        self.encoder = _SeqTower(encoder_specs(3, nf, emb_dim, ch_mult, res_blocks, img_size,
                                               attn_resolutions, last_silu), 3)
        self.quantize = VectorQuantizer(codebook_size, emb_dim, 0.25)
        self.generator = _SeqTower(generator_specs(nf, emb_dim, ch_mult, res_blocks, img_size,
                                                   attn_resolutions, last_silu), emb_dim)
        self.position_emb = nn.Parameter(torch.zeros(latent_size, dim_embd))
        self.feat_emb = nn.Linear(emb_dim, dim_embd)
        self.ft_layers = nn.ModuleList([
            TransformerSALayer(dim_embd, n_head, dim_embd * 2, mha_layout, use_pallas)
            for _ in range(n_layers)])
        self.idx_pred_layer = nn.Sequential(layer_norm(dim_embd),
                                            nn.Linear(dim_embd, codebook_size, bias=False))
        self.fuse_convs_dict = nn.ModuleDict({
            k: FuseSftBlock2D(self.CHANNELS[k], self.CHANNELS[k]) for k in self.connect_list})
        if generator is not None:
            init_weights(self, generator)

    def _apply(self, fn, *args, **kwargs):
        # the position embedding keeps its fp32 values under a dtype cast, as
        # in JAX (it is rounded to the tokens' dtype at use)
        pe = self.position_emb

        def keep(t):
            r = fn(t)
            return t.to(r.device) if t is pe and r.dtype != t.dtype else r
        return super()._apply(keep, *args, **kwargs)

    def forward(self, x: torch.Tensor, w: Optional[float] = None, detach_16: bool = True,
                code_only: bool = False, adain: Optional[bool] = None):
        N = x.shape[0]
        call = (span("pgt.call", frames=N) if profiling.current() is None
                else contextlib.nullcontext())
        with call:
            return self._forward(x, self.w if w is None else w, detach_16, code_only,
                                 self.adain if adain is None else adain)

    def _forward(self, x, w: float, detach_16: bool, code_only: bool, adain: bool):
        N = x.shape[0]
        with span("pgt.encode", frames=N):
            taps = tuple(self.FUSE_ENCODER_BLOCK[k] for k in self.connect_list)
            lq_feat, tapped = self.encoder(x, taps=taps)
            enc_feat_dict = {str(v.shape[-2]): v for v in tapped.values()}
        profiling.count("pgt.frames_encoded", N)

        with span("pgt.transformer"):
            hh, ww, cc = lq_feat.shape[1:]
            tokens = self.feat_emb(lq_feat.reshape(N, hh * ww, cc))
            pos = self.position_emb[None].to(tokens.dtype)
            for layer in self.ft_layers:
                tokens = layer(tokens, query_pos=pos)
            logits = self.idx_pred_layer(tokens)                 # [N, hw, codebook_size]
            top_idx = None if code_only else logits.argmax(dim=-1)
        if code_only:
            return logits, lq_feat

        with span("pgt.decode"):
            quant_feat = self.quantize.get_codebook_feat(top_idx, (N, hh, ww, self.emb_dim))
            quant_feat = quant_feat.to(lq_feat.dtype)
            if detach_16:
                quant_feat = quant_feat.detach()
            if adain:
                quant_feat = adaptive_instance_normalization(quant_feat, lq_feat)

            hooks = None
            if w > 0:
                def hook_for(k):
                    return lambda h: self.fuse_convs_dict[k](enc_feat_dict[k].detach(), h, w=w)
                hooks = {self.FUSE_GENERATOR_BLOCK[k]: hook_for(k) for k in self.connect_list}
            out = self.generator(quant_feat, hooks=hooks)
        return out, logits, lq_feat
