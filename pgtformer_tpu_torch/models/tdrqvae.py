"""TDRQVAE: a per-frame 2-D autoencoder with 3-D Swin temporal mixing in
latent space (PyTorch port).

Counterpart of the JAX package's ``models/tdrqvae.py`` (reference
archs/tdrqvae_arch.py:788-977), an earlier temporal variant that
``TDCRQVAE3`` superseded in the deployed model.  Frames are encoded one by
one (:class:`Encoder2D`), their latents mixed across time by
``tdswin_pre``, quantized (kernel K5 on a CUDA tensor), mixed again by
``tdswin_post`` and decoded one by one.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgtformer_tpu_torch.config import VQVAEConfig
from pgtformer_tpu_torch.models.rqvae import _RQAutoEncoder
from pgtformer_tpu_torch.nn.blocks import init_weights
from pgtformer_tpu_torch.nn.swin3d import BasicLayer3D
from pgtformer_tpu_torch.registry import ARCH_REGISTRY


@ARCH_REGISTRY.register()
class TDRQVAE(_RQAutoEncoder):
    """forward(x [B, T, H, W, 3], code_only, train, generator) -> (out
    [B, T, H, W, 3] | z_q [B, T, h, w, embed_dim], commitment loss, codes
    [B, T, h, w, depth]).  The Swin layers are built for ``cfg.tf`` frames
    of ``cfg.latent_shape`` latents (their windows clamp to that size)."""

    def __init__(self, cfg: VQVAEConfig, generator: Optional[torch.Generator] = None,
                 group=None):
        super().__init__(cfg, group)
        dd = cfg.ddconfig
        size = (cfg.tf, *cfg.latent_shape[:2])
        swin = lambda: BasicLayer3D(cfg.embed_dim, dd.stages_atten, dd.num_head,
                                    tuple(dd.window_size), input_size=size)
        self.tdswin_pre = swin()
        self.tdswin_post = swin()
        if generator is not None:
            init_weights(self, generator)

    def _mixed_latents(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        z_e = self.encode(x.reshape(B * T, H, W, C))
        return self.tdswin_pre(z_e.reshape(B, T, *z_e.shape[1:]))

    def forward(self, x: torch.Tensor, code_only: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None):
        B, T = x.shape[:2]
        z_e = self._mixed_latents(x)
        z_q, quant_loss, codes = self.quantizer(z_e.reshape(B * T, *z_e.shape[2:]),
                                                train=train, generator=generator)
        codes = codes.reshape(B, T, *codes.shape[1:])
        z_q = self.tdswin_post(z_q.reshape(B, T, *z_q.shape[1:]))
        if code_only:
            return z_q, quant_loss, codes
        out = self.decode(z_q.reshape(B * T, *z_q.shape[2:]))
        return out.reshape(B, T, *out.shape[1:]), quant_loss, codes

    def get_codes(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, H, W, 3] -> codes [B, T, h, w, depth]."""
        B, T = x.shape[:2]
        z_e = self._mixed_latents(x)
        codes = self.quantizer(z_e.reshape(B * T, *z_e.shape[2:]))[2]
        return codes.reshape(B, T, *codes.shape[1:])
