"""The native writer's encode rate (frames/s) across codec, preset and x265
thread settings, on the host alone (no device).  It tells whether the
encoder or the card sets the pace of the file path: the reference's output
format, and the CLI's default, is libx265 CRF 18 hvc1 at preset "fast".

Frames are video-like (a smooth texture moving a few pixels a frame, plus
noise), made from a seed; each row writes them through
`NativeVideoWriter.write` (RGB, the writer's swscale included) into a
temporary file, timed from open to close.

    python -m pgtformer_tpu_torch.bench_encode [--frames 96] [--size 512] [--out rows.json]

``--out`` writes the rows as JSON as well (`bench`'s dict: host cores,
frames, size, one row per case with its frames/s and kbit per frame, or the
error that kept it from running).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# codec and preset, then x265's threads (`pools` = worker threads,
# `frame-threads` = frames encoded at once)
CASES = ("mpeg4", "libx264:preset=ultrafast", "libx264:preset=fast",
         "libx265:preset=ultrafast", "libx265:preset=superfast", "libx265:preset=fast",
         "libx265:preset=medium", "libx265:preset=fast:params=pools=1,frame-threads=1",
         "libx265:preset=fast:params=pools=4,frame-threads=2")


def synth_frames(n: int, hw: int, seed: int = 0):
    """A smooth random texture moving (3, 5) pixels a frame plus noise."""
    import cv2
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (hw // 8, hw // 8, 3), np.uint8)
    base = cv2.resize(base, (hw, hw), interpolation=cv2.INTER_CUBIC)
    out = []
    for i in range(n):
        m = np.roll(base, (3 * i, 5 * i), axis=(0, 1)).astype(np.int16)
        m += rng.integers(-8, 8, m.shape, np.int16)
        out.append(np.clip(m, 0, 255).astype(np.uint8))
    return out


def bench_one(frames, fps: float, codec: str, path: str):
    """(frames/s from open to close, bytes written) of one encode."""
    from pgtformer_tpu_torch.io.native import NativeVideoWriter
    t0 = time.perf_counter()
    w = NativeVideoWriter(path, fps, frames[0].shape[:2], codec=codec)
    for f in frames:
        w.write(f)
    w.close()
    dt = time.perf_counter() - t0
    size = os.path.getsize(path)
    os.unlink(path)
    return len(frames) / dt, size


def bench(frames: int = 96, size: int = 512, codecs=None) -> dict:
    data = synth_frames(frames, size)
    rows = []
    with tempfile.TemporaryDirectory(prefix="pgt_enc_") as d:
        for codec in CASES if codecs is None else codecs:
            try:
                fps, nbytes = bench_one(data, 25.0, codec, os.path.join(d, "out.mp4"))
            except Exception as e:
                rows.append({"codec": codec, "error": str(e)})
                continue
            rows.append({"codec": codec, "fps": fps,
                         "kbits_per_frame": nbytes * 8 / 1000 / frames})
    return {"host_cores": os.cpu_count(), "frames": frames, "size": size, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    args = ap.parse_args(argv)
    out = bench(args.frames, args.size)
    print(f"host cores {out['host_cores']}, {out['frames']} frames at "
          f"{out['size']}x{out['size']}:")
    for row in out["rows"]:
        if "error" in row:
            print(f"  {row['codec']:54s} unavailable: {row['error']}")
        else:
            print(f"  {row['codec']:54s} {row['fps']:8.2f} frames/s "
                  f"{row['kbits_per_frame']:8.1f} kbit/frame")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
