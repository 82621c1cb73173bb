"""Video restoration CLI (PyTorch port).

Usage:
    python -m pgtformer_tpu_torch.cli -i input.mp4 -o output.mp4 \
        [--weights weights.pth] [--fidelity 1.0] [--batch 8] [--fp32] \
        [--codec auto|libx265|libx264|mpeg4] [--encoder-preset P] \
        [--codec-params k=v,...] [--readback auto|rgb|yuv420] [--inflight N] \
        [--encode-quality-check [--vmaf-model M]] [--dump-frames DIR] \
        [--device cuda] [--sw-kernel 5d|tokens] [--sw-pair 0|1] [--exact-vq 0|1] \
        [--fused-tail 0|up|1]

Weights: a reference-format checkpoint (.pth with `params_ema`, or
.safetensors), or a directory holding `model.safetensors` or
`pytorch_model.bin` (as `convert.from_pretrained` takes it). Without
weights the model runs with seeded random weights (pipeline smoke test
only) and a warning is printed. Runs on the card in bf16 by default, the
shifted-window layers and the code transformer's attention on the
hand-written kernels; `--fp32` computes in float32 there too (the kernels
in their fp32 form: bf16 inputs, fp32 output, as JAX's Pallas kernels;
cuDNN and cuBLAS with TF32 off). The knob flags
(pgtformer_tpu_torch/knobs.py) pick among evaluation plans that compute
the same function. Decode and encode run on the native libav shim
(io/native.py, built at first use) and fall back to OpenCV (mp4v) when it
cannot be built. It prints the frame rate and each phase's total;
`--encode-quality-check` re-decodes the output and prints PSNR/SSIM of
sampled frames and `vmaf(own-impl)` (eval/vmaf.py) against the restored
frames.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from pgtformer_tpu_torch import knobs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="PGTFormer blind video face restoration (PyTorch/CUDA)")
    parser.add_argument("-i", "--input_video", type=str, required=True,
                        help="Input video file path")
    parser.add_argument("-o", "--output_video", type=str, required=True,
                        help="Output video file path")
    parser.add_argument("--weights", type=str, default=None,
                        help="Reference-format checkpoint (.pth or .safetensors), or a "
                             "directory holding model.safetensors / pytorch_model.bin")
    parser.add_argument("--fidelity", "-w", type=float, default=1.0,
                        help="Fidelity knob w")
    parser.add_argument("--batch", type=int, default=8,
                        help="Sliding windows per device step")
    parser.add_argument("--fp32", action="store_true",
                        help="Compute in float32 (default bfloat16); on the card the "
                             "kernels take fp32 activations and TF32 is off")
    parser.add_argument("--dump-frames", type=str, default=None,
                        help="Also write restored frames as PNGs into this directory")
    parser.add_argument("--codec", type=str, default="auto",
                        choices=["auto", "libx265", "libx264", "mpeg4"],
                        help="Output codec; 'auto' prefers libx265 CRF 18 hvc1 (the "
                             "reference's output format) with x264/mpeg4 fallback")
    parser.add_argument("--encoder-preset", type=str, default=None,
                        help="x264/x265 speed preset (e.g. ultrafast, superfast, fast, "
                             "medium); trades encode CPU for bitrate at the same CRF 18")
    parser.add_argument("--codec-params", type=str, default=None,
                        help="comma-separated k=v private encoder options "
                             "(e.g. 'pools=1,frame-threads=4')")
    parser.add_argument("--readback", type=str, default="auto",
                        choices=("auto", "rgb", "yuv420"),
                        help="device->host transfer format: yuv420 converts to BT.601 "
                             "YUV420P on the device (half the bytes, no host swscale; "
                             "needs the native writer); auto picks yuv420 unless "
                             "--dump-frames/--encode-quality-check need host RGB")
    parser.add_argument("--inflight", type=int, default=3,
                        help="device chunks in flight before readback (deeper hides more "
                             "readback latency, at more device memory; 3 as in the JAX "
                             "CLI: on one H100, whose copies end within a millisecond of "
                             "their step, depths 1-3 restore within about 1%% of each "
                             "other)")
    parser.add_argument("--encode-quality-check", action="store_true",
                        help="After writing, re-decode the output and report "
                             "encoded-vs-restored PSNR/SSIM on sampled frames and "
                             "vmaf(own-impl) over the first 16")
    parser.add_argument("--vmaf-model", type=str, default=None,
                        help="VMAF model JSON for --encode-quality-check (default: "
                             "vendored vmaf_v0.6.1.json; env PGT_VMAF_MODEL also honored)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; fails without a card)")
    knobs.add_cli_flags(parser)
    args = parser.parse_args(argv)
    knobs.apply_cli_args(args)

    from pgtformer_tpu_torch import resolve_device
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.convert import load_checkpoint, local_checkpoint
    from pgtformer_tpu_torch.pipeline import VideoRestorer
    from pgtformer_tpu_torch.utils import profiling

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if dtype == torch.float32 and device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    weights = None
    if args.weights:
        weights = load_checkpoint(local_checkpoint(args.weights))
    else:
        print("WARNING: no --weights given; running with random weights "
              "(pipeline smoke test only).", file=sys.stderr)
    res = RELEASE_PGTFORMER.vqvae.ddconfig.resolution
    readback = pick_readback(args.readback,
                             bool(args.dump_frames or args.encode_quality_check), res)
    restorer = VideoRestorer(weights, RELEASE_PGTFORMER, w=args.fidelity,
                             batch_windows=args.batch, dtype=dtype, device=device,
                             readback=readback, inflight=args.inflight)
    cbs = []
    if args.dump_frames:
        import cv2
        os.makedirs(args.dump_frames, exist_ok=True)
        cbs.append(lambda i, rgb: cv2.imwrite(
            os.path.join(args.dump_frames, f"{i:08d}.png"), rgb[..., ::-1]))

    qcheck_samples = {}
    if args.encode_quality_check:
        # every 16th frame (at most 32) feeds PSNR/SSIM; the first 16
        # consecutive frames feed VMAF (motion2 needs neighbouring frames)
        cbs.append(lambda i, rgb: qcheck_samples.update({i: rgb.copy()})
                   if (i % 16 == 0 and len(qcheck_samples) < 32) or i < 16 else None)

    frame_cb = None
    if cbs:
        def frame_cb(i, rgb):
            for cb in cbs:
                cb(i, rgb)

    codec = args.codec
    if args.encoder_preset and codec != "mpeg4":
        codec = f"{codec}:preset={args.encoder_preset}"
    if args.codec_params and codec != "mpeg4":
        codec = f"{codec}:params={args.codec_params}"
    stats = restorer.restore_video(args.input_video, args.output_video, progress=True,
                                   frame_callback=frame_cb, codec=codec)
    io = (f"; reader {stats['reader']}, writer {stats['writer']}"
          if "writer" in stats else "")
    # the start-up's parts, from the tracer's spans (utils/profiling.py)
    parts = [(label, profiling.last(name)) for label, name in (
        ("prime", "pgt.prime"), ("first call's sync", "pgt.first_chunk_sync"))]
    split = ", ".join(f"{label} {s.seconds:.1f}s" for label, s in parts if s is not None)
    print(f"restored {stats['frames']} frames in {stats['seconds']:.1f}s "
          f"({stats['fps']:.2f} fps; steady {stats['steady_fps']:.2f} fps, "
          f"startup {stats['startup_seconds']:.1f}s{': ' + split if split else ''}{io})")
    phases = stats.get("phases", {})
    if phases:
        print("phase totals: " + ", ".join(f"{k} {v['total_s']:.1f}s"
                                           for k, v in phases.items()))
    if args.encode_quality_check and qcheck_samples:
        quality_check(args.output_video, qcheck_samples, args.vmaf_model)
    return 0


def pick_readback(readback: str, needs_rgb: bool, res: int) -> str:
    """`--readback auto`: yuv420 unless host RGB is needed (frame dumps, the
    quality check), the native writer does not load, or the size is odd."""
    if readback != "auto":
        return readback
    from pgtformer_tpu_torch.io import native
    try:
        native.load_library()
        has_native = True
    except Exception:
        has_native = False
    return "rgb" if (needs_rgb or not has_native or res % 2) else "yuv420"


def quality_check(output_video: str, samples: dict, vmaf_model=None) -> None:
    """Re-decode the output; print PSNR/SSIM of the sampled frames (every
    16th) and vmaf(own-impl) over the first 16 frames, encoded against
    restored."""
    from pgtformer_tpu_torch.eval import vmaf as vmaf_mod
    from pgtformer_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim
    from pgtformer_tpu_torch.pipeline import _open_reader
    model_path = vmaf_model or vmaf_mod.DEFAULT_MODEL
    scorer = vmaf_mod.VmafScorer(model_path) if os.path.exists(model_path) else None
    rd = _open_reader(output_video, "auto")
    psnrs, ssims = [], []
    for i, enc in enumerate(rd):
        if i in samples:
            a = enc.astype(np.float32) / 255.0
            b = samples[i].astype(np.float32) / 255.0
            if i % 16 == 0:
                psnrs.append(calculate_psnr(a, b))
                ssims.append(calculate_ssim(a, b))
            if scorer is not None and i < 16:
                scorer.update(b, a)        # ref = restored, dis = encoded
    rd.close()
    if psnrs:
        print(f"encode quality ({len(psnrs)} sampled frames): "
              f"psnr {np.mean(psnrs):.2f} dB, ssim {np.mean(ssims):.4f} "
              "(encoded vs restored)")
    if scorer is not None and scorer.finish():
        print(f"vmaf(own-impl) (first {len(scorer.finish())} frames): {scorer.mean():.2f}")


if __name__ == "__main__":
    sys.exit(main())
