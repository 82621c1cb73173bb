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

from pgtformer_tpu_torch import knobs
from pgtformer_tpu_torch.config import PGTFormerConfig
from pgtformer_tpu_torch.models.parser import BiSeNet
from pgtformer_tpu_torch.models.quantizer import RQBottleneck
from pgtformer_tpu_torch.models.vae import Decoder3D, Encoder3D
from pgtformer_tpu_torch.nn.blocks import (
    Float32Conv2d, KernelWeightCache, ResnetBlock, compute_dtype, conv_nhwc, init_weights,
    layer_norm)
from pgtformer_tpu_torch.nn.transformer import TransformerSALayer
from pgtformer_tpu_torch.ops.image import (
    adaptive_instance_normalization, imagenet_normalize)
from pgtformer_tpu_torch.registry import ARCH_REGISTRY
from pgtformer_tpu_torch.utils import profiling
from pgtformer_tpu_torch.utils.profiling import span


class FuseSftBlock(KernelWeightCache):
    """Controllable feature transformation with cross-frame temporal fusion
    (reference pgtformer_arch.py:435-484 `Fuse_sft_block`).

    I/O: enc_feat, dec_feat [B, T, H, W, C] -> [B, T, H, W, C], or
    [B, 1, H, W, C] with `middle_only` (only the middle frame's output is
    computed; the temporal path still reads every frame).

    The temporal path (per-frame 1x1 convs `tconvenc`/`tconvdec` to `tcc`
    channels, then `tfusion0` mixing frames and channels) runs the
    ``FUSE_TPATH`` knob's plan, each rounding where the JAX package's same
    plan does: ``conv`` folds the 1x1 convs into tfusion0's kernel in fp32,
    rounds the folded kernels once and sums over (frame, channel) in one
    product per input; ``einsum`` runs the 1x1 convs (bias added in the
    compute dtype), then one product over (frame, tcc channel) per input.
    The three convs keep fp32 parameters under a dtype cast.  Under a
    recorded gradient the folded weights are derived from the live
    parameters, else cached."""

    def __init__(self, in_ch: int, out_ch: int, t: int = 3, tcc: int = 32):
        super().__init__()
        self.t = t
        self.tcc = tcc
        self.tconvenc = Float32Conv2d(in_ch, tcc, 1)
        self.tconvdec = Float32Conv2d(in_ch, tcc, 1)
        # input channels t-major [enc frames | dec frames], output t-major
        self.tfusion0 = Float32Conv2d(2 * t * tcc, t * tcc, 1)
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

    def _tpath_weights(self, plan: str, T: int, middle_only: bool, dt: torch.dtype):
        """The temporal path's weights, (frame, channel) rows by (output
        frame, tcc) columns, rounded to `dt`: for ``conv`` the folded
        (Ke [T*C, s*d], Kd, bc [s*d]); for ``einsum`` (ke [tcc, C], be, kd,
        bd, k_enc [T*tcc, s*d], k_dec, b_sd)."""
        def build():
            tcc, mid = self.tcc, T // 2
            with torch.autocast(self.tfusion0.weight.device.type, enabled=False):
                kf = self.tfusion0.weight[:, :, 0, 0].t()       # [(enc|dec, t, c), (s, d)]
                k_enc = kf[:T * tcc].reshape(T, tcc, T, tcc)
                k_dec = kf[T * tcc:].reshape(T, tcc, T, tcc)
                b_sd = self.tfusion0.bias.reshape(T, tcc)
                if middle_only:         # only the middle output frame is consumed
                    k_enc, k_dec, b_sd = (k_enc[:, :, mid:mid + 1], k_dec[:, :, mid:mid + 1],
                                          b_sd[mid:mid + 1])
                sd = b_sd.numel()
                ke, kd = self.tconvenc.weight[:, :, 0, 0], self.tconvdec.weight[:, :, 0, 0]
                if plan == "conv":
                    fold = lambda k, kt: torch.einsum("ic,tisd->tcsd", k, kt).reshape(-1, sd)
                    bc = (torch.einsum("i,tisd->sd", self.tconvenc.bias, k_enc)
                          + torch.einsum("i,tisd->sd", self.tconvdec.bias, k_dec) + b_sd)
                    out = (fold(ke, k_enc), fold(kd, k_dec), bc.reshape(sd))
                else:
                    out = (ke, self.tconvenc.bias, kd, self.tconvdec.bias,
                           k_enc.reshape(-1, sd), k_dec.reshape(-1, sd), b_sd.reshape(sd))
                return tuple(w.to(dt) for w in out)
        if torch.is_grad_enabled() and self.tfusion0.weight.requires_grad:
            return build()
        return self._cached((plan, T, middle_only, dt), build,
                            (self.tconvenc, self.tconvdec, self.tfusion0))

    def forward(self, enc_feat: torch.Tensor, dec_feat: torch.Tensor,
                w: float = 1.0, middle_only: bool = False) -> torch.Tensor:
        B, T, H, W, C = enc_feat.shape
        tcc = self.tcc
        dt = compute_dtype(enc_feat)
        plan = knobs.get("FUSE_TPATH")
        wts = self._tpath_weights(plan, T, middle_only, dt)
        # [B, T, H, W, c] -> rows (b, h, w) by columns (t, c)
        rows = lambda a: a.reshape(B, T, H, W, -1).permute(0, 2, 3, 1, 4).reshape(B * H * W, -1)
        if plan == "conv":
            Ke, Kd, bc = wts
            fut = rows(enc_feat.to(dt)) @ Ke + rows(dec_feat.to(dt)) @ Kd + bc
        else:
            ke, be, kd, bd, k_enc, k_dec, b_sd = wts
            enct = F.linear(enc_feat.to(dt), ke) + be
            dect = F.linear(dec_feat.to(dt), kd) + bd
            fut = rows(enct) @ k_enc + rows(dect) @ k_dec + b_sd
        t_out, mid = fut.shape[-1] // tcc, T // 2
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


@ARCH_REGISTRY.register()
class PGTFormer(nn.Module):
    """Blind video face restoration model.

    forward(x [B, T, H, W, 3] in [0,1]) -> (out [B*T, H, W, 3],
    logits [B*T, h, w, depth, n_embed], lq_feat [B*T, h, w, embed_dim]), or
    (logits, lq_feat) with `code_only` (training stage II).  The decoder
    sees the encoder's skip features with their gradient stopped, and with
    `detach_16` the looked-up codes too (gradients still reach lq_feat
    through AdaIN's statistics), as in the JAX package.
    With `generator`, every weight is initialized from it.  `use_pallas`
    (JAX's name and default) runs the shifted-window layers and the code
    transformer's attention through the kernels (nn/blocks.py:EncoderLayer,
    nn/transformer.py:MultiHeadSelfAttention); `mha_layout` is then the
    attention's plan ("bnhd" or "bhnd")."""

    def __init__(self, cfg: PGTFormerConfig, generator: Optional[torch.Generator] = None,
                 mha_layout: str = "bnhd", use_pallas: bool = False):
        super().__init__()
        self.cfg = cfg
        vq = cfg.vqvae
        dd = vq.ddconfig
        self.encoder = Encoder3D(dd, num_frames=vq.tf, use_pallas=use_pallas)
        self.decoder = Decoder3D(dd, num_frames=vq.tf, use_pallas=use_pallas)
        self.quantizer = RQBottleneck(vq.latent_shape, vq.code_shape, vq.n_embed, vq.decay,
                                      vq.shared_codebook, vq.restart_unused_codes)
        self.quant_conv = nn.Conv2d(dd.z_channels, vq.embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(vq.embed_dim, dd.z_channels, 1)
        latent_res = dd.resolution // 2 ** (dd.num_resolutions - 1)
        self.conditionnet = BiSeNet(cfg.n_parsing_classes, (latent_res, latent_res))
        self.convpos = nn.Conv2d(3 * cfg.n_parsing_classes, cfg.dim_embd, 1)
        self.feat_emb = nn.Linear(vq.embed_dim, cfg.dim_embd)
        self.ft_layers = nn.ModuleList([
            TransformerSALayer(cfg.dim_embd, cfg.n_head, cfg.dim_embd * 2, mha_layout,
                               use_pallas)
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

    def forward(self, x: torch.Tensor, w: Optional[float] = None, detach_16: bool = True,
                code_only: bool = False, adain: Optional[bool] = None,
                middle_only: bool = False):
        B, T, H, W, _ = x.shape
        pos, trunk_h, trunk_feats = self.encode_frames(x.reshape(B * T, H, W, 3))
        to_win = lambda a: a.reshape(B, T, *a.shape[1:])
        return self.restore_windows(to_win(pos), to_win(trunk_h),
                                    tuple(to_win(f) for f in trunk_feats),
                                    w=w, detach_16=detach_16, code_only=code_only,
                                    adain=adain, middle_only=middle_only)

    def encode_frames(self, frames: torch.Tensor):
        """Per-frame compute: frames [F, H, W, 3] in [0,1] -> (query-pos
        embedding [F, th, tw, C], encoder-trunk features [F, h', w', C'],
        tuple of per-frame trunk skip features).  Frames may be fp32 in a
        bf16 model: the parser's input is normalized in fp32 and the trunk's
        taken as it is, each rounded once to the model's dtype."""
        dtype = self.convpos.weight.dtype
        cond = self.conditionnet(imagenet_normalize(frames).to(dtype))
        pos = conv_nhwc(self.convpos, cond)
        trunk_h, trunk_feats = self.encoder(frames[None].to(dtype), stage="trunk")
        return pos, trunk_h[0], tuple(f[0] for f in trunk_feats)

    def restore_windows(self, pos, trunk_h, trunk_feats, w: Optional[float] = None,
                        detach_16: bool = True, code_only: bool = False,
                        adain: Optional[bool] = None, middle_only: bool = False):
        """Per-window compute over gathered per-frame features (each
        [B, T, ...]): encoder attention levels, transformer, code
        prediction, fuse-SFT decode.  Returns (out, logits, lq_feat); `out`
        is [B*T, H, W, 3], or [B, H, W, 3] with `middle_only`.  Traced as
        the spans ``pgt.attn``, ``pgt.transformer`` and ``pgt.decode``
        (utils/profiling.py)."""
        cfg = self.cfg
        w = cfg.w if w is None else w
        adain = cfg.adain if adain is None else adain
        B, T, th, tw, pc = pos.shape
        query_pos = pos.reshape(B, T * th * tw, pc)

        with span("pgt.attn"):
            z, head_feats = self.encoder(trunk_h, return_multi_res_feats=True, stage="head")
            feats = list(trunk_feats) + list(head_feats)
            enc_feat_dict = {f: feats[self.fuse_encoder_indices[f]] for f in cfg.connect_list}
            lq_feat = conv_nhwc(self.quant_conv, z)

        with span("pgt.transformer"):
            tokens = self.feat_emb(lq_feat)
            tokens = tokens.reshape(B, T * th * tw, tokens.shape[-1])
            for layer in self.ft_layers:
                tokens = layer(tokens, query_pos=query_pos)
            logits = self.idx_pred_layer(tokens).reshape(
                B * T, th, tw, self.quantizer_depth, self.codebook_size)
            codes = None if code_only else logits.argmax(dim=-1)
        if code_only:
            return logits, lq_feat
        with span("pgt.decode"):
            out = self._decode_restored(codes, lq_feat, enc_feat_dict, w=w,
                                        detach_16=detach_16, adain=adain,
                                        middle_only=middle_only)
        profiling.count("pgt.windows_restored", B)
        return out, logits, lq_feat

    def _decode_restored(self, codes, lq_feat, enc_feat_dict: Dict[str, torch.Tensor],
                         *, w: float, adain: bool, detach_16: bool = True,
                         middle_only: bool = False):
        """Codebook lookup -> (detach / AdaIN) -> fuse-SFT decode."""
        quant_feat = self.quantizer.embed_code(codes).to(lq_feat.dtype)
        if detach_16:
            quant_feat = quant_feat.detach()
        if adain:
            quant_feat = adaptive_instance_normalization(quant_feat, lq_feat)
        fuse_fn = None
        fuse_resolutions = ()
        if w > 0:
            fuse_resolutions = tuple(int(k) for k in self.fuse_convs_dict)

            def fuse_fn(resolution, h, middle_only=False):
                key = str(resolution)
                if key in self.fuse_convs_dict:
                    h = self.fuse_convs_dict[key](enc_feat_dict[key].detach(), h, w=w,
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
