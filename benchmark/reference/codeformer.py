"""Plain float32 CodeFormer, as github.com/sczhou/CodeFormer publishes it.

``archs/codeformer_arch.py`` over ``archs/vqgan_arch.py``, channels-last,
with the reference checkpoint's parameter names: the VQGAN encoder (blocks
indexed as the checkpoint's ``encoder.blocks.{i}``), 9 pre-norm transformer
layers over the 16x16 latent tokens with a learned position embedding, the
code-index head, the codebook lookup with AdaIN, and the generator with the
non-temporal Fuse-SFT blocks after the generator blocks that the published
model names, fed by the encoder blocks it names.

:func:`restore_faces` is ``inference_codeformer.py``'s step: uint8 faces
normalized to [-1, 1], the forward at fidelity weight w, the output mapped
back to uint8.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

from reference.layers import (
    Conv2d, Downsample, GroupNorm, LeakyReLU, Linear, ResnetBlock, TransformerSALayer,
    Upsample, adain, layer_norm, matmul)

FUSE_ENCODER_BLOCK = {"512": 2, "256": 5, "128": 8, "64": 11, "32": 14, "16": 18}
FUSE_GENERATOR_BLOCK = {"16": 6, "32": 9, "64": 12, "128": 15, "256": 18, "512": 21}
CHANNELS = {"16": 512, "32": 256, "64": 256, "128": 128, "256": 128, "512": 64}


class AttnBlock(nn.Module):
    """Single-head attention over the H*W tokens, scaled by C^-1/2."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v = Conv2d(c, c, 1), Conv2d(c, c, 1), Conv2d(c, c, 1)
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.norm(x)
        tok = lambda conv: conv(h).reshape(B, H * W, C)
        q, k, v = tok(self.q), tok(self.k), tok(self.v)
        attn = torch.softmax(matmul(q, k.transpose(1, 2)) * C ** -0.5, dim=-1)
        return x + self.proj_out(matmul(attn, v).reshape(B, H, W, C))


def encoder_specs(nf, emb_dim, ch_mult, res_blocks, res, attn_res):
    specs = [("conv", nf)]
    ch = nf
    for i, m in enumerate(ch_mult):
        for _ in range(res_blocks):
            specs.append(("res", nf * m))
            ch = nf * m
            if res in attn_res:
                specs.append(("attn", None))
        if i != len(ch_mult) - 1:
            specs.append(("down", None))
            res //= 2
    return specs + [("res", ch), ("attn", None), ("res", ch), ("norm", None),
                    ("conv", emb_dim)]


def generator_specs(nf, ch_mult, res_blocks, img_size, attn_res):
    ch = nf * ch_mult[-1]
    res = img_size // 2 ** (len(ch_mult) - 1)
    specs = [("conv", ch), ("res", ch), ("attn", None), ("res", ch)]
    for i in reversed(range(len(ch_mult))):
        for _ in range(res_blocks):
            specs.append(("res", nf * ch_mult[i]))
            if res in attn_res:
                specs.append(("attn", None))
        if i != 0:
            specs.append(("up", None))
            res *= 2
    return specs + [("norm", None), ("conv", 3)]


class Tower(nn.Module):
    """The indexed block list ``blocks.{i}``; `taps` collects the output of
    the listed blocks, `hooks[i]` runs on block i's output."""

    def __init__(self, specs, cin: int):
        super().__init__()
        blocks = []
        ch = cin
        for kind, arg in specs:
            if kind == "conv":
                blocks.append(Conv2d(ch, arg, 3, padding=1))
                ch = arg
            elif kind == "res":
                blocks.append(ResnetBlock(ch, arg, shortcut_name="conv_out"))
                ch = arg
            elif kind == "attn":
                blocks.append(AttnBlock(ch))
            elif kind == "down":
                blocks.append(Downsample(ch))
            elif kind == "up":
                blocks.append(Upsample(ch))
            else:
                blocks.append(GroupNorm(ch))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, taps=(), hooks=None):
        tapped = {}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in taps:
                tapped[i] = x
            if hooks and i in hooks:
                x = hooks[i](x)
        return x, tapped


class FuseSftBlock2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.encode_enc = ResnetBlock(2 * ch, ch, shortcut_name="conv_out")
        self.scale = nn.Sequential(Conv2d(ch, ch, 3, padding=1), LeakyReLU(),
                                   Conv2d(ch, ch, 3, padding=1))
        self.shift = nn.Sequential(Conv2d(ch, ch, 3, padding=1), LeakyReLU(),
                                   Conv2d(ch, ch, 3, padding=1))

    def forward(self, enc, dec, w):
        feat = self.encode_enc(torch.cat([enc, dec], dim=-1))
        return dec + w * (dec * self.scale(feat) + self.shift(feat))


class CodeFormer(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg
        nf, cm, rb = cfg["nf"], tuple(cfg["ch_mult"]), cfg["res_blocks"]
        attn = tuple(cfg["attn_resolutions"])
        self.emb_dim = cfg["emb_dim"]
        self.encoder = Tower(encoder_specs(nf, cfg["emb_dim"], cm, rb, cfg["img_size"], attn), 3)
        self.quantize = nn.Module()
        self.quantize.embedding = nn.Module()       # the codebook, looked up by index
        self.quantize.embedding.weight = nn.Parameter(
            torch.zeros(cfg["codebook_size"], cfg["emb_dim"]))
        self.generator = Tower(generator_specs(nf, cm, rb, cfg["img_size"], attn), cfg["emb_dim"])
        self.position_emb = nn.Parameter(torch.zeros(cfg["latent_size"], cfg["dim_embd"]))
        self.feat_emb = Linear(cfg["emb_dim"], cfg["dim_embd"])
        self.ft_layers = nn.ModuleList([
            TransformerSALayer(cfg["dim_embd"], cfg["n_head"], 2 * cfg["dim_embd"])
            for _ in range(cfg["n_layers"])])
        self.idx_pred_layer = nn.Sequential(
            layer_norm(cfg["dim_embd"]), Linear(cfg["dim_embd"], cfg["codebook_size"], bias=False))
        # the published block tables; a configuration may relabel them
        self.enc_block = cfg.get("FUSE_ENCODER_BLOCK", FUSE_ENCODER_BLOCK)
        self.gen_block = cfg.get("FUSE_GENERATOR_BLOCK", FUSE_GENERATOR_BLOCK)
        channels = cfg.get("CHANNELS", CHANNELS)
        self.fuse_convs_dict = nn.ModuleDict({
            k: FuseSftBlock2D(channels[k]) for k in cfg["connect_list"]})

    def forward(self, x, w: float, use_adain: bool):
        """x [N, H, W, 3] in [-1, 1] -> out [N, H, W, 3], unclamped."""
        N = x.shape[0]
        keys = tuple(self.cfg["connect_list"])
        lq, tapped = self.encoder(x, taps=tuple(self.enc_block[k] for k in keys))
        enc = {k: tapped[self.enc_block[k]] for k in keys}
        hh, ww, cc = lq.shape[1:]
        tok = self.feat_emb(lq.reshape(N, hh * ww, cc))
        for layer in self.ft_layers:
            tok = layer(tok, self.position_emb[None])
        codes = self.idx_pred_layer(tok).argmax(dim=-1)
        quant = self.quantize.embedding.weight[codes].reshape(N, hh, ww, self.emb_dim)
        if use_adain:
            quant = adain(quant, lq)
        hooks = None
        if w > 0:
            hooks = {self.gen_block[k]:
                     (lambda k: lambda h: self.fuse_convs_dict[k](enc[k], h, w))(k)
                     for k in keys}
        return self.generator(quant, hooks=hooks)[0]


def to_signed(faces_u8: torch.Tensor) -> torch.Tensor:
    return (faces_u8.float() / 255.0 - 0.5) / 0.5


def to_u8(out: torch.Tensor) -> torch.Tensor:
    return ((out.float().clamp(-1.0, 1.0) + 1.0) * 0.5 * 255.0).round().to(torch.uint8)


@torch.no_grad()
def restore_faces(model: CodeFormer, faces_u8: torch.Tensor, w: float, use_adain: bool,
                  block: int = 8) -> torch.Tensor:
    """uint8 faces [N, H, W, 3] -> restored uint8 faces, `block` at a time."""
    dt = model.feat_emb.weight.dtype
    return torch.cat([to_u8(model(to_signed(faces_u8[s:s + block]).to(dt), w, use_adain))
                      for s in range(0, faces_u8.shape[0], block)])
