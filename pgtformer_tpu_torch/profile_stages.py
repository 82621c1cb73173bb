"""Per-stage time of the serving step (the cached-trunk, middle-only step
that `VideoRestorer.restore_chunk` runs), stage by stage.

Builds RELEASE_PGTFORMER with seeded random weights, primes it with one
seeded frame and times, each on its own inputs (the previous stage's
outputs), with CUDA events on a card or the host clock on the CPU:
`encode_frames` (parser + encoder trunk, B frames), the window gather,
the encoder head (attention levels + mid + `quant_conv`), the 9
`TransformerSALayer`s (with `feat_emb`), the idx head and code lookup
(argmax, `embed_code`, AdaIN, `post_quant_conv`), `Decoder3D` with the
fuse-SFT skips (middle frame only), and the readback conversion (uint8
RGB and YUV420).  The stages run apart, so their sum over-counts the whole
step a little (no overlap of launches with the device); the whole step is
printed beside it for calibration.  The stages composed give the whole
step's frames bit for bit (checked).

    python -m pgtformer_tpu_torch.profile_stages [--batch 8] [--iters 10] \
        [--device cuda] [knob flags]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from pgtformer_tpu_torch import knobs


def _timer(device: torch.device, iters: int):
    """fn -> ms per call, after 2 warm-up calls."""
    def run(fn):
        for _ in range(2):
            fn()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    return run


def stage_functions(r):
    """The serving step of VideoRestorer `r` cut into its stages: a list of
    (name, fn) where each fn takes the previous stage's output."""
    from pgtformer_tpu_torch.nn.blocks import conv_nhwc
    from pgtformer_tpu_torch.ops.image import adaptive_instance_normalization
    from pgtformer_tpu_torch.pipeline import _rgb_to_yuv420
    m, cfg, w = r.model, r.cfg, r.w

    def gather(ff_new):
        ff = [torch.cat([a, b]) for a, b in zip(r._tail, ff_new)]
        return [a[r._win_idx] for a in ff]

    def head(windows):
        pos, trunk, *skips = windows
        z, head_feats = m.encoder(trunk, return_multi_res_feats=True, stage="head")
        feats = list(skips) + list(head_feats)
        enc = {f: feats[m.fuse_encoder_indices[f]] for f in cfg.connect_list}
        return pos, conv_nhwc(m.quant_conv, z), enc

    def transformer(x):
        pos, lq_feat, enc = x
        B, T, th, tw, pc = pos.shape
        query_pos = pos.reshape(B, T * th * tw, pc)
        tokens = m.feat_emb(lq_feat).reshape(B, T * th * tw, -1)
        for layer in m.ft_layers:
            tokens = layer(tokens, query_pos=query_pos)
        return tokens, lq_feat, enc, (B * T, th, tw)

    def codes(x):
        tokens, lq_feat, enc, (n, th, tw) = x
        logits = m.idx_pred_layer(tokens).reshape(n, th, tw, m.quantizer_depth,
                                                  m.codebook_size)
        quant = m.quantizer.embed_code(logits.argmax(dim=-1)).to(lq_feat.dtype)
        if cfg.adain:
            quant = adaptive_instance_normalization(quant, lq_feat)
        return conv_nhwc(m.post_quant_conv, quant), enc

    def decoder(x):
        z_dec, enc = x
        fuse_fn, fuse_resolutions = None, ()
        if w > 0:
            fuse_resolutions = tuple(int(k) for k in m.fuse_convs_dict)

            def fuse_fn(resolution, h, middle_only=False):
                key = str(resolution)
                if key in m.fuse_convs_dict:
                    h = m.fuse_convs_dict[key](enc[key], h, w=w, middle_only=middle_only)
                return h
        return m.decoder(z_dec, fuse_fn=fuse_fn, middle_only=True,
                         fuse_resolutions=fuse_resolutions)

    return [("encode_frames (parser + trunk, B frames)", r._encode),
            ("window gather", gather),
            ("encoder head (attention levels + mid)", head),
            (f"transformer ({len(m.ft_layers)} TransformerSALayer)", transformer),
            ("idx head + code lookup (+ AdaIN, post_quant)", codes),
            ("Decoder3D + fuse-SFT (middle frame)", decoder),
            ("readback conversion: uint8 RGB",
             lambda out: (out.float().clamp(0, 1) * 255.0).round().to(torch.uint8)),
            ("readback conversion: YUV420", lambda out: _rgb_to_yuv420(out.float().clamp(0, 1)))]


def profile(batch: int = 8, iters: int = 10, device=None) -> dict:
    """Per-stage ms (as `stage_functions` names them), their sum, the whole
    step's ms, and the device's name."""
    from pgtformer_tpu_torch import resolve_device
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.pipeline import VideoRestorer

    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    res = RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    r = VideoRestorer(None, RELEASE_PGTFORMER, batch_windows=batch, dtype=dtype,
                      device=device, seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (batch + 1, res, res, 3),
                                               dtype=np.uint8)
    r.prime(frames[0])
    with torch.inference_mode():
        return _profile(r, r._upload(frames[1:]), _timer(device, iters), batch, res, device)


def _profile(r, new, timeit, batch, res, device) -> dict:
    """`profile` on a primed restorer `r` and its uploaded frames `new`."""
    stages, x, conversions = {}, new, {}
    for name, fn in stage_functions(r):
        if name.startswith("readback"):
            conversions[name] = fn(x)
            stages[name] = timeit(lambda fn=fn, x=x: fn(x))
            continue
        stages[name] = timeit(lambda fn=fn, x=x: fn(x))
        x = fn(x)
    tail = r._tail
    whole = r._step(new)
    r._tail = tail
    if not torch.equal(whole, conversions["readback conversion: uint8 RGB"]):
        raise SystemExit("profile_stages: the stages composed differ from the whole step")

    def step():
        r._step(new)
        r._tail = tail
    step_ms = timeit(step)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"device": name, "batch": batch, "res": res, "stages_ms": stages,
            "stage_sum_ms": sum(stages.values()) - stages["readback conversion: YUV420"],
            "step_ms": step_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; fails without a card)")
    knobs.add_cli_flags(ap)
    args = ap.parse_args(argv)
    knobs.apply_cli_args(args)
    p = profile(args.batch, args.iters, args.device)
    print(f"device {p['device']}; serving step B={p['batch']} {p['res']}x{p['res']}, "
          f"ms per call over {args.iters} calls:")
    for name, ms in p["stages_ms"].items():
        print(f"  {name:46s} {ms:9.3f} ms")
    print(f"  {'stage sum (RGB readback)':46s} {p['stage_sum_ms']:9.3f} ms; "
          f"whole step {p['step_ms']:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
