"""End-to-end video restoration pipeline (PyTorch port, one device).

The serving step of the JAX package's ``pipeline.py``: every decoded
frame is uploaded once as uint8 and its per-frame features (parsing
prior, encoder trunk) are computed once (``encode_frames``); a device-side
tail keeps the features of the last 2r frames, so each step gathers B
sliding windows of T frames from ``concat(tail, new)`` and restores only
their middle frames (``restore_windows(middle_only=True)``).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from pgtformer_tpu_torch import resolve_device
from pgtformer_tpu_torch.config import PGTFormerConfig, RELEASE_PGTFORMER
from pgtformer_tpu_torch.convert import load_into
from pgtformer_tpu_torch.io.video import VideoReader, VideoWriter
from pgtformer_tpu_torch.models.pgtformer import PGTFormer

# restored chunks left on the device before the oldest is read back, so the
# host's decode and upload of the next chunk overlap the device's work
_INFLIGHT = 2


def _rgb_to_yuv420(out: torch.Tensor):
    """Float RGB [B, H, W, 3] in [0,1] -> BT.601 limited-range YUV420P
    planes (y [B, H, W], u/v [B, H/2, W/2], uint8), on the tensor's device.
    Chroma is the mean of each 2x2 block."""
    r_, g_, b_ = out[..., 0], out[..., 1], out[..., 2]
    y = 16.0 + 65.481 * r_ + 128.553 * g_ + 24.966 * b_
    u = 128.0 - 37.797 * r_ - 74.203 * g_ + 112.0 * b_
    v = 128.0 + 112.0 * r_ - 93.786 * g_ - 18.214 * b_
    n, h, w = u.shape
    u = u.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    v = v.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    q = lambda t: t.round().clamp(0.0, 255.0).to(torch.uint8)
    return q(y), q(u), q(v)


class VideoRestorer:
    """Batched sliding-window restorer around a PGTFormer.

    `weights`: a reference-format state_dict (numpy or torch values); None
    initializes every weight from `seed` (for smoke tests and benchmarks).
    `device`: `cuda` unless given; without a card this raises.
    `readback`: 'rgb' (uint8 [B, H, W, 3]) or 'yuv420' (device-side BT.601
    planes from :meth:`restore_chunk`; :meth:`restore_video` writes RGB).
    `mha_layout`: the code transformer's attention plan ("bnhd" or "bhnd")."""

    def __init__(self, weights=None, cfg: PGTFormerConfig = RELEASE_PGTFORMER,
                 w: float = 1.0, batch_windows: int = 8,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 readback: str = "rgb", seed: int = 0, mha_layout: str = "bnhd"):
        if readback not in ("rgb", "yuv420"):
            raise ValueError(f"readback {readback!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.w = float(w)
        self.batch = batch_windows
        self.readback = readback
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed) if weights is None else None
        model = PGTFormer(cfg, generator=gen, mha_layout=mha_layout)
        if weights is not None:
            load_into(model, weights)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        T = cfg.vqvae.tf
        self.radius = (T - 1) // 2
        # window i covers frames [i, i+T) of concat(tail(2r), new(B))
        self._win_idx = torch.stack(
            [torch.arange(i, i + T) for i in range(batch_windows)]).to(self.device)
        self._tail: Optional[List[torch.Tensor]] = None
        self._first_chunk_s: Optional[float] = None
        self._prime_s = 0.0

    def _upload(self, frames_u8) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(frames_u8))
        return t.to(self.device)

    def _encode(self, frames_u8: torch.Tensor) -> List[torch.Tensor]:
        """[F, H, W, 3] uint8 -> flat per-frame features [pos, trunk, *skips]."""
        x = frames_u8.to(torch.float32) / 255.0
        pos, trunk, skips = self.model.encode_frames(x)
        return [pos, trunk, *skips]

    def _restore(self, windows: List[torch.Tensor]):
        pos, trunk, *skips = windows
        out, _, _ = self.model.restore_windows(pos, trunk, tuple(skips), w=self.w,
                                               middle_only=True)
        out = out.to(torch.float32).clamp(0.0, 1.0)
        if self.readback == "yuv420":
            return _rgb_to_yuv420(out)
        return (out * 255.0).round().to(torch.uint8)

    @torch.inference_mode()
    def _step(self, new_u8: torch.Tensor):
        ff_new = self._encode(new_u8)
        ff = [torch.cat([a, b]) for a, b in zip(self._tail, ff_new)]
        out = self._restore([a[self._win_idx] for a in ff])
        r = self.radius
        self._tail = [a[-2 * r:] if r else a[:0] for a in ff]
        return out

    def reset(self):
        self._tail = None
        self._first_chunk_s = None
        self._prime_s = 0.0

    def prime(self, first_frame: np.ndarray):
        """Left padding: the first frame duplicated 2r times, its features
        cached as the tail."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            self._tail = self._encode(self._upload(
                np.repeat(first_frame[None], 2 * self.radius, axis=0)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prime_s = time.perf_counter() - t0

    def restore_chunk(self, new_frames_u8):
        """new_frames_u8 [B, H, W, 3] uint8 -> restored [B, H, W, 3] uint8 on
        the device (or YUV420 planes), returned without waiting for the
        device.  `prime()` must come first."""
        if self._tail is None:
            raise RuntimeError("call prime() before restore_chunk()")
        if self._first_chunk_s is None:
            t0 = time.perf_counter()
            out = self._step(self._upload(new_frames_u8))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._first_chunk_s = time.perf_counter() - t0
            return out
        return self._step(self._upload(new_frames_u8))

    def restore_video(self, input_path: str, output_path: str,
                      progress: bool = False, frame_callback=None) -> dict:
        """Restore a video file to an mp4v file; returns frame count and
        timing.  `frame_callback(index, rgb_u8)` runs per restored frame."""
        if self.readback != "rgb":
            raise ValueError("restore_video writes RGB frames; use readback='rgb'")
        reader = VideoReader(input_path)
        writer = None
        B, r = self.batch, self.radius
        n_frames = 0
        pending: List = []
        self.reset()
        t0 = time.perf_counter()

        def drain(entry):
            nonlocal writer, n_frames
            out, n_valid = entry
            frames = out[:n_valid].cpu().numpy()
            for f in frames:
                if writer is None:
                    writer = VideoWriter(output_path, reader.fps, f.shape[:2])
                writer.write(f)
                if frame_callback is not None:
                    frame_callback(n_frames, f)
                n_frames += 1
            if progress and n_frames % 64 < n_valid:
                print(f"  {n_frames} frames...", flush=True)

        def flush(chunk, n_valid):
            pending.append((self.restore_chunk(np.stack(chunk)), n_valid))
            if len(pending) > _INFLIGHT:
                drain(pending.pop(0))

        # prime() consumes frame 0; then every chunk of B new frames yields B
        # restored centers.  At stream end the q buffered frames owe q + r
        # more outputs, produced from chunks padded with the last frame.
        try:
            chunk: List[np.ndarray] = []
            last_frame = None
            for frame in reader:
                if last_frame is None:
                    self.prime(frame)
                    last_frame = frame
                    continue
                last_frame = frame
                chunk.append(frame)
                if len(chunk) == B:
                    flush(chunk, B)
                    chunk = []
            if last_frame is None:
                return {"frames": 0, "seconds": 0.0, "fps": 0.0}
            needed = len(chunk) + r
            while needed > 0:
                chunk.extend([last_frame] * (B - len(chunk)))
                n_valid = min(B, needed)
                flush(chunk, n_valid)
                needed -= n_valid
                chunk = []
            for entry in pending:
                drain(entry)
        finally:
            reader.close()
            if writer is not None:
                writer.close()
        dt = time.perf_counter() - t0
        startup = (self._first_chunk_s or 0.0) + self._prime_s
        steady = dt - startup
        steady_frames = max(n_frames - B, 0)
        return {"frames": n_frames, "seconds": dt,
                "fps": n_frames / dt if dt > 0 else 0.0,
                "startup_seconds": startup,
                "steady_fps": steady_frames / steady if steady > 0 else 0.0}
