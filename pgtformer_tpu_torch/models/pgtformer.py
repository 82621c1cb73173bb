"""PGTFormer — parsing-guided temporal-coherent transformer (PyTorch port).

Counterpart of the JAX package's ``models/pgtformer.py``: BiSeNet parsing
prior -> positional embedding of a pre-norm transformer over the T*h*w
latent tokens (t-major) -> code-index prediction -> codebook lookup ->
frozen VQ decoder with temporal Fuse-SFT skips weighted by `w`.
Parameter names are the reference state_dict's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pgtformer_tpu_torch.config import PGTFormerConfig
from pgtformer_tpu_torch.models.parser import BiSeNet
from pgtformer_tpu_torch.models.quantizer import RQBottleneck
from pgtformer_tpu_torch.models.vae import Decoder3D, Encoder3D
from pgtformer_tpu_torch.nn.blocks import ResnetBlock, conv_nhwc, init_weights, layer_norm
from pgtformer_tpu_torch.nn.transformer import TransformerSALayer
from pgtformer_tpu_torch.ops.image import (
    adaptive_instance_normalization, imagenet_normalize)


class FuseSftBlock(nn.Module):
    """Controllable feature transformation with cross-frame temporal fusion
    (reference pgtformer_arch.py:435-484 `Fuse_sft_block`).

    I/O: enc_feat, dec_feat [B, T, H, W, C] -> [B, T, H, W, C], or
    [B, 1, H, W, C] with `middle_only` (only the middle frame's output is
    computed; the temporal path still reads every frame)."""

    def __init__(self, in_ch: int, out_ch: int, t: int = 3, tcc: int = 32):
        super().__init__()
        self.t = t
        self.tcc = tcc
        self.tconvenc = nn.Conv2d(in_ch, tcc, 1)
        self.tconvdec = nn.Conv2d(in_ch, tcc, 1)
        # input channels t-major [enc frames | dec frames], output t-major
        self.tfusion0 = nn.Conv2d(2 * t * tcc, t * tcc, 1)
        self.tfusion1 = nn.Conv2d(tcc, tcc, 1)
        self.encode_enc = ResnetBlock(2 * in_ch + tcc, out_ch, shortcut_name="conv_out")
        self.scale = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, padding=1),
                                   nn.LeakyReLU(0.2), nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.shift = nn.Sequential(nn.Conv2d(out_ch, out_ch, 3, padding=1),
                                   nn.LeakyReLU(0.2), nn.Conv2d(out_ch, out_ch, 3, padding=1))

    def init_extra(self, g: torch.Generator) -> None:
        # last SFT convs start at zero: the block starts as the identity
        with torch.no_grad():
            for head in (self.scale, self.shift):
                head[2].weight.zero_()
                head[2].bias.zero_()

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor,
                w: float = 1.0, middle_only: bool = False) -> torch.Tensor:
        B, T, H, W, C = enc_feat.shape
        tcc = self.tcc
        enct = conv_nhwc(self.tconvenc, enc_feat.reshape(B * T, H, W, C))
        dect = conv_nhwc(self.tconvdec, dec_feat.reshape(B * T, H, W, C))
        fold = lambda a: a.reshape(B, T, H, W, tcc).permute(0, 2, 3, 1, 4).reshape(
            B, H, W, T * tcc)
        weight = self.tfusion0.weight[:, :, 0, 0]          # [(s, d), (enc|dec, t, c)]
        bias = self.tfusion0.bias
        t_out, mid = T, T // 2
        if middle_only:
            weight = weight[mid * tcc:(mid + 1) * tcc]
            bias = bias[mid * tcc:(mid + 1) * tcc]
            t_out = 1
        fut = F.linear(torch.cat([fold(enct), fold(dect)], dim=-1), weight, bias)
        fut = fut.reshape(B, H, W, t_out, tcc).permute(0, 3, 1, 2, 4)
        fut = conv_nhwc(self.tfusion1, fut.reshape(B * t_out, H, W, tcc))

        if middle_only:
            enc_feat = enc_feat[:, mid:mid + 1]
            dec_feat = dec_feat[:, mid:mid + 1]
        enc = enc_feat.reshape(B * t_out, H, W, C)
        dec = dec_feat.reshape(B * t_out, H, W, C)
        feat = self.encode_enc(torch.cat([enc, dec, fut], dim=-1))
        scale = conv_nhwc(self.scale[2], F.leaky_relu(conv_nhwc(self.scale[0], feat), 0.2))
        shift = conv_nhwc(self.shift[2], F.leaky_relu(conv_nhwc(self.shift[0], feat), 0.2))
        out = dec + w * (dec * scale + shift)
        return out.reshape(B, t_out, H, W, -1)


class PGTFormer(nn.Module):
    """Blind video face restoration model.

    forward(x [B, T, H, W, 3] in [0,1]) -> (out [B*T, H, W, 3],
    logits [B*T, h, w, depth, n_embed], lq_feat [B*T, h, w, embed_dim]).
    With `generator`, every weight is initialized from it.  `mha_layout`
    is the code transformer's attention plan ("bnhd" or "bhnd", see
    nn/transformer.py)."""

    def __init__(self, cfg: PGTFormerConfig, generator: Optional[torch.Generator] = None,
                 mha_layout: str = "bnhd"):
        super().__init__()
        self.cfg = cfg
        vq = cfg.vqvae
        dd = vq.ddconfig
        self.encoder = Encoder3D(dd, num_frames=vq.tf)
        self.decoder = Decoder3D(dd, num_frames=vq.tf)
        self.quantizer = RQBottleneck(vq.latent_shape, vq.code_shape, vq.n_embed,
                                      vq.shared_codebook)
        self.quant_conv = nn.Conv2d(dd.z_channels, vq.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(vq.embed_dim, dd.z_channels, 1)
        latent_res = dd.resolution // 2 ** (dd.num_resolutions - 1)
        self.conditionnet = BiSeNet(cfg.n_parsing_classes, (latent_res, latent_res))
        self.convpos = nn.Conv2d(3 * cfg.n_parsing_classes, cfg.dim_embd, 1)
        self.feat_emb = nn.Linear(vq.embed_dim, cfg.dim_embd)
        self.ft_layers = nn.ModuleList([
            TransformerSALayer(cfg.dim_embd, cfg.n_head, cfg.dim_embd * 2, mha_layout)
            for _ in range(cfg.n_layers)])
        self.codebook_size = vq.n_embed if isinstance(vq.n_embed, int) else vq.n_embed[-1]
        self.quantizer_depth = vq.code_shape[-1]
        self.idx_pred_layer = nn.Sequential(
            layer_norm(cfg.dim_embd),
            nn.Linear(cfg.dim_embd, self.quantizer_depth * self.codebook_size, bias=False))
        self.channels = {}
        self.fuse_encoder_indices = {}
        for i in range(dd.num_resolutions):
            res = str(dd.resolution // 2 ** i)
            self.channels[res] = dd.ch * dd.ch_mult[i]
            self.fuse_encoder_indices[res] = i
        self.fuse_convs_dict = nn.ModuleDict({
            f: FuseSftBlock(self.channels[f], self.channels[f], t=vq.tf)
            for f in cfg.connect_list})
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x: torch.Tensor, w: Optional[float] = None,
                adain: Optional[bool] = None, middle_only: bool = False):
        B, T, H, W, _ = x.shape
        pos, trunk_h, trunk_feats = self.encode_frames(x.reshape(B * T, H, W, 3))
        to_win = lambda a: a.reshape(B, T, *a.shape[1:])
        return self.restore_windows(to_win(pos), to_win(trunk_h),
                                    tuple(to_win(f) for f in trunk_feats),
                                    w=w, adain=adain, middle_only=middle_only)

    def encode_frames(self, frames: torch.Tensor):
        """Per-frame compute: frames [F, H, W, 3] in [0,1] -> (query-pos
        embedding [F, th, tw, C], encoder-trunk features [F, h', w', C'],
        tuple of per-frame trunk skip features)."""
        cond = self.conditionnet(imagenet_normalize(frames))
        pos = conv_nhwc(self.convpos, cond)
        trunk_h, trunk_feats = self.encoder(frames[None], stage="trunk")
        return pos, trunk_h[0], tuple(f[0] for f in trunk_feats)

    def restore_windows(self, pos, trunk_h, trunk_feats, w: Optional[float] = None,
                        adain: Optional[bool] = None, middle_only: bool = False,
                        code_only: bool = False):
        """Per-window compute over gathered per-frame features (each
        [B, T, ...]): encoder attention levels, transformer, code
        prediction, fuse-SFT decode.  Returns (out, logits, lq_feat); `out`
        is [B*T, H, W, 3], or [B, H, W, 3] with `middle_only`."""
        cfg = self.cfg
        w = cfg.w if w is None else w
        adain = cfg.adain if adain is None else adain
        B, T, th, tw, pc = pos.shape
        query_pos = pos.reshape(B, T * th * tw, pc)

        z, head_feats = self.encoder(trunk_h, return_multi_res_feats=True, stage="head")
        feats = list(trunk_feats) + list(head_feats)
        enc_feat_dict = {f: feats[self.fuse_encoder_indices[f]] for f in cfg.connect_list}
        lq_feat = conv_nhwc(self.quant_conv, z)

        tokens = self.feat_emb(lq_feat)
        tokens = tokens.reshape(B, T * th * tw, tokens.shape[-1])
        for layer in self.ft_layers:
            tokens = layer(tokens, query_pos=query_pos)
        logits = self.idx_pred_layer(tokens).reshape(
            B * T, th, tw, self.quantizer_depth, self.codebook_size)
        if code_only:
            return logits, lq_feat
        codes = logits.argmax(dim=-1)
        out = self._decode_restored(codes, lq_feat, enc_feat_dict, w=w, adain=adain,
                                    middle_only=middle_only)
        return out, logits, lq_feat

    def _decode_restored(self, codes, lq_feat, enc_feat_dict: Dict[str, torch.Tensor],
                         *, w: float, adain: bool, middle_only: bool = False):
        """Codebook lookup -> (AdaIN) -> fuse-SFT decode."""
        quant_feat = self.quantizer.embed_code(codes).to(lq_feat.dtype)
        if adain:
            quant_feat = adaptive_instance_normalization(quant_feat, lq_feat)
        fuse_fn = None
        fuse_resolutions = ()
        if w > 0:
            fuse_resolutions = tuple(int(k) for k in self.fuse_convs_dict)

            def fuse_fn(resolution, h, middle_only=False):
                key = str(resolution)
                if key in self.fuse_convs_dict:
                    h = self.fuse_convs_dict[key](enc_feat_dict[key], h, w=w,
                                                  middle_only=middle_only)
                return h

        z_dec = conv_nhwc(self.post_quant_conv, quant_feat)
        return self.decoder(z_dec, fuse_fn=fuse_fn, middle_only=middle_only,
                            fuse_resolutions=fuse_resolutions)

    def restore_from_codes(self, x: torch.Tensor, codes: torch.Tensor,
                           w: Optional[float] = None, adain: Optional[bool] = None,
                           middle_only: bool = False) -> torch.Tensor:
        """Restore x [B, T, H, W, 3] with externally supplied codes
        [B*T, h, w, depth] (the forced-code parity path) -> [B*T, H, W, 3],
        or the middle frames [B, H, W, 3] with `middle_only`."""
        cfg = self.cfg
        w = cfg.w if w is None else w
        adain = cfg.adain if adain is None else adain
        z, feats = self.encoder(x, return_multi_res_feats=True)
        enc_feat_dict = {f: feats[self.fuse_encoder_indices[f]] for f in cfg.connect_list}
        lq_feat = conv_nhwc(self.quant_conv, z)
        return self._decode_restored(codes, lq_feat, enc_feat_dict, w=w, adain=adain,
                                     middle_only=middle_only)

    # -- the autoencoder's code path (as TDCRQVAE3's methods) ------------------
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, H, W, 3] -> z_e [B*T, h, w, embed_dim]."""
        return conv_nhwc(self.quant_conv, self.encoder(x))

    def get_codes(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, H, W, 3] -> codes [B*T, h, w, depth]."""
        return self.quantizer(self.encode(x))[2]

    def decode_code(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B*T, h, w, depth] -> frames [B*T, H, W, 3] (no fuse skips)."""
        z_q = self.quantizer.embed_code(codes).to(self.post_quant_conv.weight.dtype)
        return self.decoder(conv_nhwc(self.post_quant_conv, z_q))
