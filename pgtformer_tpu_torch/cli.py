"""Video restoration CLI (PyTorch port).

Usage:
    python -m pgtformer_tpu_torch.cli -i input.mp4 -o output.mp4 \
        [--weights weights.pth] [--fidelity 1.0] [--batch 8] [--fp32] \
        [--dump-frames DIR] [--device cuda] \
        [--sw-kernel 5d|tokens] [--sw-pair 0|1] [--exact-vq 0|1]

Weights: a reference-format checkpoint (.pth with `params_ema`, or
.safetensors).  Without weights the model runs with seeded random weights
(pipeline smoke test only) and a warning is printed.  Runs on the card in
bf16 by default; the hand-written kernels take bf16 only, so `--fp32`
needs `--device cpu`.  The knob flags (pgtformer_tpu_torch/knobs.py) pick
among evaluation plans that compute the same function.
"""

from __future__ import annotations

import argparse
import os
import sys

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
                        help="Reference-format checkpoint (.pth or .safetensors)")
    parser.add_argument("--fidelity", "-w", type=float, default=1.0,
                        help="Fidelity knob w")
    parser.add_argument("--batch", type=int, default=8,
                        help="Sliding windows per device step")
    parser.add_argument("--fp32", action="store_true",
                        help="Compute in float32 (default bfloat16; CPU only)")
    parser.add_argument("--dump-frames", type=str, default=None,
                        help="Also write restored frames as PNGs into this directory")
    parser.add_argument("--readback", type=str, default="rgb", choices=("rgb",),
                        help="Device->host transfer format")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; fails without a card)")
    knobs.add_cli_flags(parser)
    args = parser.parse_args(argv)
    knobs.apply_cli_args(args)

    from pgtformer_tpu_torch import resolve_device
    from pgtformer_tpu_torch.config import RELEASE_PGTFORMER
    from pgtformer_tpu_torch.convert import load_checkpoint
    from pgtformer_tpu_torch.pipeline import VideoRestorer

    device = resolve_device(args.device)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if dtype == torch.float32 and device.type == "cuda":
        parser.error("--fp32 needs --device cpu: the CUDA kernels take bf16")
    weights = None
    if args.weights:
        weights = load_checkpoint(args.weights)
    else:
        print("WARNING: no --weights given; running with random weights "
              "(pipeline smoke test only).", file=sys.stderr)
    restorer = VideoRestorer(weights, RELEASE_PGTFORMER, w=args.fidelity,
                             batch_windows=args.batch, dtype=dtype, device=device,
                             readback=args.readback)
    frame_cb = None
    if args.dump_frames:
        import cv2
        os.makedirs(args.dump_frames, exist_ok=True)

        def frame_cb(i, rgb):
            cv2.imwrite(os.path.join(args.dump_frames, f"{i:08d}.png"), rgb[..., ::-1])

    stats = restorer.restore_video(args.input_video, args.output_video,
                                   progress=True, frame_callback=frame_cb)
    print(f"restored {stats['frames']} frames in {stats['seconds']:.1f}s "
          f"({stats['fps']:.2f} fps; steady {stats['steady_fps']:.2f} fps, "
          f"startup {stats.get('startup_seconds', 0.0):.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
