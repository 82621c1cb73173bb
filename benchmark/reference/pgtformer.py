"""Plain float32 PGTFormer: the serving step's function, written out.

The model of github.com/kepengxu/PGTFormer (``pgtformer_arch.py``) at the
release option file's settings, channels-last, with the reference
checkpoint's parameter names: a BiSeNet parsing prior projected by
``convpos`` to the transformer's query positions, the encoder tower (its
attention-free levels per frame, then the shifted-window levels over T
frames), 9 pre-norm transformer layers over the T*h*w latent tokens, the
code-index head, the codebook lookup with AdaIN, and the decoder with the
temporal Fuse-SFT skips weighted by w.

:func:`serve_chunk` is the serving step: frames enter as uint8, each frame's
features are computed once, windows of T consecutive frames are restored,
and only each window's middle frame leaves, as uint8.  The decoder drops
the other frames after its last stage that mixes frames, which changes no
middle-frame value.

Plan knobs, kernels and caches are absent by design: the comparison holds
the port to this function.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.layers import (
    Conv2d, Downsample, EncoderLayer, GroupNorm, LeakyReLU, Linear, ResnetBlock,
    TransformerSALayer, Upsample, adain, layer_norm)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# -- BiSeNet (ResNet-18 context path), frozen batch norms -----------------------

class FrozenBN(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        return (x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5) * self.weight \
            + self.bias


def _conv(cin, cout, ks, stride=1, padding=0):
    return Conv2d(cin, cout, ks, stride=stride, padding=padding, bias=False)


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = _conv(cin, cout, ks, stride, padding)
        self.bn = FrozenBN(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, 1)
        self.bn1 = FrozenBN(cout)
        self.conv2 = _conv(cout, cout, 3, 1, 1)
        self.bn2 = FrozenBN(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), FrozenBN(cout))

    def forward(self, x):
        r = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        s = x if self.downsample is None else self.downsample[1](self.downsample[0](x))
        return F.relu(s + r)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBN(64)
        layer = lambda cin, cout, s: nn.Sequential(BasicBlock(cin, cout, s), BasicBlock(cout, cout))
        self.layer1 = layer(64, 64, 1)
        self.layer2 = layer(64, 128, 2)
        self.layer3 = layer(128, 256, 2)
        self.layer4 = layer(256, 512, 2)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        f8 = self.layer2(self.layer1(x))
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


def _gap(x):
    return x.mean(dim=(1, 2), keepdim=True)


def _nearest(x, hw):
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest").permute(0, 2, 3, 1)


class ARM(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = _conv(cout, cout, 1)
        self.bn_atten = FrozenBN(cout)

    def forward(self, x):
        f = self.conv(x)
        return f * torch.sigmoid(self.bn_atten(self.conv_atten(_gap(f))))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = ARM(256, 128)
        self.arm32 = ARM(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, ks=1, padding=0)

    def forward(self, x):
        f8, f16, f32 = self.resnet(x)
        avg = _nearest(self.conv_avg(_gap(f32)), f32.shape[1:3])
        f32_up = self.conv_head32(_nearest(self.arm32(f32) + avg, f16.shape[1:3]))
        f16_up = self.conv_head16(_nearest(self.arm16(f16) + f32_up, f8.shape[1:3]))
        return f8, f16_up, f32_up


class FFM(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, ks=1, padding=0)
        self.conv1 = _conv(cout, cout // 4, 1)
        self.conv2 = _conv(cout // 4, cout, 1)

    def forward(self, fsp, fcp):
        f = self.convblk(torch.cat([fsp, fcp], dim=-1))
        a = torch.sigmoid(self.conv2(F.relu(self.conv1(_gap(f)))))
        return f * a + f


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, mid, n):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = _conv(mid, n, 1)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    """ImageNet-normalized [N, H, W, 3] -> the 3*n-channel prior at `out_hw`."""

    def __init__(self, n: int, out_hw):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.cp = ContextPath()
        self.ffm = FFM(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n)
        self.conv_out16 = BiSeNetOutput(128, 64, n)
        self.conv_out32 = BiSeNetOutput(128, 64, n)

    def forward(self, x):
        f8, cp8, cp16 = self.cp(x)
        outs = [self.conv_out(self.ffm(f8, cp8)), self.conv_out16(cp8), self.conv_out32(cp16)]
        up = lambda o: F.interpolate(o.permute(0, 3, 1, 2), size=self.out_hw, mode="bilinear",
                                     align_corners=True).permute(0, 2, 3, 1)
        return torch.cat([up(o) for o in outs], dim=-1)


# -- the video autoencoder's towers --------------------------------------------

def _encoder_layer(dd: Mapping, dim: int, level: int, T: int) -> EncoderLayer:
    return EncoderLayer(dim, dd["depths"][level], dd["num_heads"][level], T,
                        tuple(dd["window_sizes"][level]), mlp_ratio=1.0)


def _levels(dd: Mapping) -> List[int]:
    return [dd["resolution"] // 2 ** i for i in range(len(dd["ch_mult"]))]


class Mid(nn.Module):
    def __init__(self, dd, dim, T):
        super().__init__()
        self.block_1 = ResnetBlock(dim)
        self.attn_1 = _encoder_layer(dd, dim, -1, T)
        self.block_2 = ResnetBlock(dim)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder3D(nn.Module):
    def __init__(self, dd: Mapping, T: int):
        super().__init__()
        self.dd = dd
        self.conv_in = Conv2d(dd["in_channels"], dd["ch"], 3, padding=1)
        self.down = nn.ModuleList()
        cin = dd["ch"]
        n = len(dd["ch_mult"])
        for i, res in enumerate(_levels(dd)):
            cout = dd["ch"] * dd["ch_mult"][i]
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(dd["num_res_blocks"]):
                level.block.append(ResnetBlock(cin, cout))
                cin = cout
                if res in dd["attn_resolutions"]:
                    level.attn.append(_encoder_layer(dd, cin, i, T))
            if i != n - 1:
                level.downsample = Downsample(cin)
            self.down.append(level)
        self.mid = Mid(dd, cin, T)
        self.norm_out = GroupNorm(cin)
        self.conv_out = Conv2d(cin, dd["z_channels"], 3, padding=1)
        self.split = next((i for i, r in enumerate(_levels(dd)) if r in dd["attn_resolutions"]), n)

    def run_levels(self, h, levels, feats):
        n = len(self.dd["ch_mult"])
        for i in levels:
            level = self.down[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            feats.append(h)
            if i != n - 1:
                h = level.downsample(h)
        return h

    def trunk(self, frames):
        """[F, H, W, 3] -> (h [F, ...], per-level features [F, ...]): the
        levels before the first attention, each frame on its own."""
        feats: List[torch.Tensor] = []
        h = self.run_levels(self.conv_in(frames)[None], range(self.split), feats)
        return h[0], [f[0] for f in feats]

    def head(self, h):
        """Windows [B, T, ...] of trunk output -> (z [B*T, h, w, z], features)."""
        feats: List[torch.Tensor] = []
        h = self.mid(self.run_levels(h, range(self.split, len(self.dd["ch_mult"])), feats))
        h, lead = h.reshape(-1, *h.shape[2:]), h.shape[:2]
        return self.conv_out(F.silu(self.norm_out(h))), feats


class Decoder3D(nn.Module):
    def __init__(self, dd: Mapping, T: int):
        super().__init__()
        self.dd, self.T = dd, T
        n = len(dd["ch_mult"])
        cin = dd["ch"] * dd["ch_mult"][-1]
        res = dd["resolution"] // 2 ** (n - 1)
        self.conv_in = Conv2d(dd["z_channels"], cin, 3, padding=1)
        self.mid = Mid(dd, cin, T)
        levels = {}
        for i in reversed(range(n)):
            cout = dd["ch"] * dd["ch_mult"][i]
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(dd["num_res_blocks"] + 1):
                level.block.append(ResnetBlock(cin, cout))
                cin = cout
                if res in dd["attn_resolutions"]:
                    level.attn.append(_encoder_layer(dd, cin, i, T))
            if i != 0:
                level.upsample = Upsample(cin)
                res *= 2
            levels[i] = level
        self.up = nn.ModuleList([levels[i] for i in range(n)])
        self.norm_out = GroupNorm(cin)
        self.conv_out = Conv2d(cin, dd["out_ch"], 3, padding=1)

    def forward(self, z, fuse, fuse_res: Sequence[int]):
        """z [B*T, h, w, z] -> the middle frames [B, H, W, out_ch].  `fuse(res,
        h, middle_only)` runs after each level's blocks; every stage after
        the last one that mixes frames runs on the middle frame alone."""
        dd, T = self.dd, self.T
        n = len(dd["ch_mult"])
        order = list(reversed(range(n)))
        res = {i: dd["resolution"] // 2 ** i for i in order}
        mixing = [i for i in order if res[i] in dd["attn_resolutions"] or res[i] in fuse_res]
        last_mix = mixing[-1] if mixing else None
        h = self.mid.block_1(self.conv_in(z))
        h = self.mid.block_2(self.mid.attn_1(h.reshape(-1, T, *h.shape[1:])))
        t = T
        if last_mix is None:
            h, t = h[:, T // 2:T // 2 + 1], 1
        for i in order:
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[j](h)
            at_last = i == last_mix
            if res[i] in fuse_res:
                mid = at_last
                h = fuse(res[i], h, mid)
                if mid:
                    t = 1
            if at_last and t == T:
                h, t = h[:, T // 2:T // 2 + 1], 1
            if i != 0:
                h = level.upsample(h)
        h = h.reshape(-1, *h.shape[2:])
        return self.conv_out(F.silu(self.norm_out(h)))


class FuseSftBlock(nn.Module):
    """Temporal Fuse-SFT: per-frame 1x1 convs of enc and dec to `tcc`
    channels, a 1x1 conv over all frames' channels ([enc frames | dec
    frames], t-major) to T*tcc, a per-frame 1x1 conv; then a resblock over
    [enc | dec | fused] gives scale and shift: dec + w * (dec * scale + shift)."""

    def __init__(self, ch: int, T: int, tcc: int = 32):
        super().__init__()
        self.T, self.tcc = T, tcc
        self.tconvenc = Conv2d(ch, tcc, 1)
        self.tconvdec = Conv2d(ch, tcc, 1)
        self.tfusion0 = Conv2d(2 * T * tcc, T * tcc, 1)
        self.tfusion1 = Conv2d(tcc, tcc, 1)
        self.encode_enc = ResnetBlock(2 * ch + tcc, ch, shortcut_name="conv_out")
        self.scale = nn.Sequential(Conv2d(ch, ch, 3, padding=1), LeakyReLU(),
                                   Conv2d(ch, ch, 3, padding=1))
        self.shift = nn.Sequential(Conv2d(ch, ch, 3, padding=1), LeakyReLU(),
                                   Conv2d(ch, ch, 3, padding=1))

    def forward(self, enc, dec, w: float, middle_only: bool):
        B, T, H, W, C = enc.shape
        tcc = self.tcc
        frames = lambda a: a.permute(0, 2, 3, 1, 4).reshape(B, H, W, T * tcc)
        e = frames(self.tconvenc(enc.reshape(B * T, H, W, C)).reshape(B, T, H, W, tcc))
        d = frames(self.tconvdec(dec.reshape(B * T, H, W, C)).reshape(B, T, H, W, tcc))
        fut = self.tfusion0(torch.cat([e, d], dim=-1)).reshape(B, H, W, T, tcc)
        fut = fut.permute(0, 3, 1, 2, 4)
        if middle_only:
            m = T // 2
            fut, enc, dec = fut[:, m:m + 1], enc[:, m:m + 1], dec[:, m:m + 1]
        t = fut.shape[1]
        fut = self.tfusion1(fut.reshape(B * t, H, W, tcc))
        enc, dec = enc.reshape(B * t, H, W, C), dec.reshape(B * t, H, W, C)
        feat = self.encode_enc(torch.cat([enc, dec, fut], dim=-1))
        out = dec + w * (dec * self.scale(feat) + self.shift(feat))
        return out.reshape(B, t, H, W, C)


class Codebook(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n + 1, dim))
        self.register_buffer("cluster_size_ema", torch.zeros(n))
        self.register_buffer("embed_ema", torch.zeros(n, dim))


class PGTFormer(nn.Module):
    def __init__(self, cfg: Mapping):
        super().__init__()
        self.cfg = cfg
        dd, T = cfg["ddconfig"], cfg["tf"]
        self.T = T
        self.encoder = Encoder3D(dd, T)
        self.decoder = Decoder3D(dd, T)
        self.quantizer = nn.Module()
        self.quantizer.codebooks = nn.ModuleList([Codebook(cfg["n_embed"], cfg["embed_dim"])])
        self.quant_conv = Conv2d(dd["z_channels"], cfg["embed_dim"], 1)
        self.post_quant_conv = Conv2d(cfg["embed_dim"], dd["z_channels"], 1)
        lat = dd["resolution"] // 2 ** (len(dd["ch_mult"]) - 1)
        self.conditionnet = BiSeNet(cfg["n_parsing_classes"], (lat, lat))
        self.convpos = Conv2d(3 * cfg["n_parsing_classes"], cfg["dim_embd"], 1)
        self.feat_emb = Linear(cfg["embed_dim"], cfg["dim_embd"])
        self.ft_layers = nn.ModuleList([
            TransformerSALayer(cfg["dim_embd"], cfg["n_head"], 2 * cfg["dim_embd"])
            for _ in range(cfg["n_layers"])])
        self.idx_pred_layer = nn.Sequential(
            layer_norm(cfg["dim_embd"]),
            Linear(cfg["dim_embd"], cfg["n_embed"], bias=False))
        self.channels = {str(r): dd["ch"] * m for r, m in zip(_levels(dd), dd["ch_mult"])}
        self.level_of = {str(r): i for i, r in enumerate(_levels(dd))}
        self.fuse_convs_dict = nn.ModuleDict({
            k: FuseSftBlock(self.channels[k], T) for k in cfg["connect_list"]})

    def encode_frames(self, frames: torch.Tensor):
        """frames [F, H, W, 3] in [0, 1], float32 -> per-frame (pos, trunk h,
        trunk features), in the model's dtype."""
        dt = self.convpos.weight.dtype
        mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
        std = torch.tensor(IMAGENET_STD, device=frames.device)
        pos = self.convpos(self.conditionnet(((frames - mean) / std).to(dt)))
        h, feats = self.encoder.trunk(frames.to(dt))
        return [pos, h, *feats]

    def restore_windows(self, feats: List[torch.Tensor], w: float, use_adain: bool):
        """Per-frame features gathered into windows ([B, T, ...] each) ->
        the windows' middle frames [B, H, W, 3], unclamped."""
        pos, h, *trunk_feats = feats
        B, T, th, tw, pc = pos.shape
        z, head_feats = self.encoder.head(h)
        enc_feats = list(trunk_feats) + head_feats
        lq = self.quant_conv(z)
        tok = self.feat_emb(lq).reshape(B, T * th * tw, -1)
        qpos = pos.reshape(B, T * th * tw, pc)
        for layer in self.ft_layers:
            tok = layer(tok, qpos)
        logits = self.idx_pred_layer(tok)
        codes = logits.argmax(dim=-1).reshape(B * T, th, tw)
        quant = self.quantizer.codebooks[0].weight[codes]
        if use_adain:
            quant = adain(quant, lq)
        cfg = self.cfg
        skips = {k: enc_feats[self.level_of[k]] for k in cfg["connect_list"]}

        def fuse(res, hh, middle_only):
            key = str(res)
            return self.fuse_convs_dict[key](skips[key], hh, w, middle_only)
        fuse_res = tuple(int(k) for k in cfg["connect_list"]) if w > 0 else ()
        return self.decoder(self.post_quant_conv(quant), fuse, fuse_res)


def to_unit(frames_u8: torch.Tensor) -> torch.Tensor:
    return frames_u8.float() / 255.0


def to_u8(out: torch.Tensor) -> torch.Tensor:
    return (out.float().clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)


@torch.no_grad()
def serve_chunk(model: PGTFormer, context_u8: torch.Tensor, w: float, use_adain: bool,
                window_block: int = 4) -> torch.Tensor:
    """The serving step from its inputs: `context_u8` [B + T - 1, H, W, 3]
    uint8 frames, the 2r frames before the chunk's first new frame (its
    left context) then the B new ones; window i covers context frames
    [i, i + T).  Returns the B windows' restored middle frames, uint8
    [B, H, W, 3].  Windows run `window_block` at a time."""
    T = model.T
    B = context_u8.shape[0] - T + 1
    feats = model.encode_frames(to_unit(context_u8))
    idx = torch.stack([torch.arange(i, i + T) for i in range(B)]).to(context_u8.device)
    outs = []
    for s in range(0, B, window_block):
        sel = idx[s:s + window_block]
        outs.append(to_u8(model.restore_windows([f[sel] for f in feats], w, use_adain)))
    return torch.cat(outs)


def chunk_context(chunk: int, batch: int, clip_frames: int, radius: int) -> np.ndarray:
    """Indices, into a clip of `clip_frames` frames, of the frames chunk
    `chunk` restores from: the clip's first frame stands in 2r times before
    its start (the left padding), its last frame after its end (the right
    padding); chunk k's new frames are 1 + k*B ... (k+1)*B."""
    first = chunk * batch - 2 * radius + 1
    return np.clip(np.arange(first, first + batch + 2 * radius), 0, clip_frames - 1)

