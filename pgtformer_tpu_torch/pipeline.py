"""End-to-end video restoration pipeline (PyTorch port).

The serving step of the JAX package's ``pipeline.py``: every decoded
frame is uploaded once as uint8 and its per-frame features (parsing
prior, encoder trunk) are computed once (``encode_frames``); a device-side
tail keeps the features of the last 2r frames, so each step gathers B
sliding windows of T frames from ``concat(tail, new)`` and restores only
their middle frames (``restore_windows(middle_only=True)``).

``restore_video`` overlaps four things, as the JAX version does: the
decode on the host, the device (`inflight` chunks enqueued before the
oldest is read back), the readback (a 2-worker pool; on a card each chunk
is copied on a side stream into pinned host memory, so a copy waits only
for its own step), and the encode (a writer thread).  Decode and encode
run on the native libav shim (io/native.py) or on OpenCV.

Across several devices (``group=``, one process per device,
``parallel/group.py``) each rank restores B/n of a chunk's windows: the
JAX package's halo-exchange ``shard_map`` step, with rank 0 reading and
writing the file.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from pgtformer_tpu_torch import default_use_pallas, resolve_device
from pgtformer_tpu_torch.config import PGTFormerConfig, RELEASE_PGTFORMER
from pgtformer_tpu_torch.convert import load_into
from pgtformer_tpu_torch.io.video import VideoReader, VideoWriter
from pgtformer_tpu_torch.models.pgtformer import PGTFormer
from pgtformer_tpu_torch.parallel import group as P
from pgtformer_tpu_torch.utils import profiling
from pgtformer_tpu_torch.utils.profiling import StageTimer, span

# what rank 0 asks the other ranks to do next (VideoRestorer with a group)
_OP_STOP, _OP_PRIME, _OP_CHUNK = 0, 1, 2


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


def _pack(feats: List[torch.Tensor]):
    """Per-frame features (each [F, ...], any dtypes) -> (uint8 [F, bytes],
    each frame's bytes in one row; the layout that :func:`_unpack` reads)."""
    F = feats[0].shape[0]
    rows = [a.contiguous().view(torch.uint8).reshape(F, -1) for a in feats]
    layout = [(a.dtype, tuple(a.shape[1:]), r.shape[1]) for a, r in zip(feats, rows)]
    return torch.cat(rows, dim=1), layout


def _unpack(rows: torch.Tensor, layout) -> List[torch.Tensor]:
    out, off = [], 0
    for dtype, shape, nbytes in layout:
        out.append(rows[:, off:off + nbytes].contiguous().view(dtype)
                   .reshape(rows.shape[0], *shape))
        off += nbytes
    return out


def _open_reader(path: str, backend: str):
    """`backend` 'native' (libav shim), 'opencv', or 'auto' (native, else
    OpenCV)."""
    if backend in ("native", "auto"):
        try:
            from pgtformer_tpu_torch.io.native import NativeVideoReader
            return NativeVideoReader(path)
        except Exception:
            if backend == "native":
                raise
    return VideoReader(path)


def _open_writer(path: str, fps: float, size_hw, backend: str, codec: str = "auto"):
    """As `_open_reader`; `codec` reaches the native writer only (OpenCV
    writes mp4v).  Under 'auto' a codec that the native writer cannot open
    (no library, or an explicitly requested encoder missing from libav)
    falls back to OpenCV mp4v as in the JAX package; an explicit codec that
    falls back is warned about, and `restore_video` reports the writer."""
    if backend in ("native", "auto"):
        try:
            from pgtformer_tpu_torch.io.native import NativeVideoWriter
            return NativeVideoWriter(path, fps, size_hw, codec=codec)
        except Exception as e:
            if backend == "native":
                raise
            if codec != "auto":
                warnings.warn(f"codec {codec!r} not written: the native writer failed "
                              f"({str(e).strip().splitlines()[-1] if str(e).strip() else e!r}); "
                              "writing OpenCV mp4v instead (io_backend='native' raises)",
                              RuntimeWarning, stacklevel=2)
    return VideoWriter(path, fps, size_hw)


def _describe(io, codec=None) -> str:
    """Which backend `_open_reader` / `_open_writer` chose: 'opencv',
    'opencv:mp4v' (the writer), 'native' or 'native:<requested codec>'."""
    if isinstance(io, VideoReader):
        return "opencv"
    if isinstance(io, VideoWriter):
        return "opencv:mp4v"
    return "native" if codec is None else f"native:{codec}"


class VideoRestorer:
    """Batched sliding-window restorer around a PGTFormer.

    `weights`: a reference-format state_dict (numpy or torch values); None
    initializes every weight from `seed` (for smoke tests and benchmarks).
    `device`: `cuda` unless given; without a card this raises.
    `readback`: 'rgb' (uint8 [B, H, W, 3]) or 'yuv420' (the device converts
    to BT.601 YUV420P planes: half the device->host bytes and no host
    swscale; :meth:`restore_video` then needs the native writer and even
    H/W, and has no RGB frames for a callback).
    `mha_layout`: the code transformer's attention plan ("bnhd" or "bhnd").
    `use_pallas`: the model's plan (models/pgtformer.py); None, as in JAX,
    means the kernels where the device is CUDA and the module path
    elsewhere.  `dtype` bf16 or fp32: under fp32 the kernels round their
    inputs to bf16 and store fp32, as the TPU kernels do, and the rest of
    the model computes in fp32 (TF32 is the caller's setting; the CLIs turn
    it off).
    `io_backend`: 'auto' (native libav, else OpenCV), 'native' or 'opencv'.
    `inflight`: chunks left on the device before the oldest is read back
    (at least 1): deeper hides more readback latency at `inflight` chunks
    of device memory.  The default is the JAX package's; on one H100 the
    side-stream copies leave no latency to hide, and depths 1-3 restore a
    file within about 1% of each other (PERF.md, the inflight sweep).
    `group`: a :class:`~pgtformer_tpu_torch.parallel.group.Group` of more
    than one rank serves each chunk across the ranks (the JAX package's
    `mesh`): every rank builds the restorer with the same arguments and
    weights (the group's device is the restorer's), and
    :meth:`_sharded_step` says what each one computes.  Rank 0 alone holds
    the frames: its :meth:`prime`, :meth:`restore_chunk` and
    :meth:`restore_video` take them, send each rank its share and return the
    whole chunk's output; every other rank makes the same calls in the same
    order without frames (None; :meth:`restore_video` with no paths) and
    gets None back."""

    def __init__(self, weights=None, cfg: PGTFormerConfig = RELEASE_PGTFORMER,
                 w: float = 1.0, batch_windows: int = 8,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 readback: str = "rgb", seed: int = 0, mha_layout: str = "bnhd",
                 io_backend: str = "auto", inflight: int = 3,
                 group: Optional[P.Group] = None, use_pallas: Optional[bool] = None):
        if readback not in ("rgb", "yuv420"):
            raise ValueError(f"readback {readback!r}")
        if io_backend not in ("auto", "native", "opencv"):
            raise ValueError(f"io_backend {io_backend!r}")
        if group is not None and device is not None and torch.device(device) != group.device:
            raise ValueError(f"device {device} is not the group's {group.device}")
        self.device = group.device if group is not None else resolve_device(device)
        self.io_backend = io_backend
        self.inflight = max(1, inflight)
        self.cfg = cfg
        self.w = float(w)
        self.batch = batch_windows
        self.readback = readback
        self.dtype = dtype
        gen = torch.Generator().manual_seed(seed) if weights is None else None
        if use_pallas is None:
            use_pallas = default_use_pallas(self.device)
        model = PGTFormer(cfg, generator=gen, mha_layout=mha_layout, use_pallas=use_pallas)
        if weights is not None:
            load_into(model, weights)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        T = cfg.vqvae.tf
        self.radius = r = (T - 1) // 2
        self.group = group if group is not None and group.world > 1 else None
        windows = batch_windows
        if self.group is not None:
            n = self.group.world
            if batch_windows % n:
                raise ValueError(f"batch_windows {batch_windows} does not divide over {n} ranks")
            windows = batch_windows // n
            if r < 1 or batch_windows < 2 * r:
                raise ValueError("a chunk must cover the temporal halo (r >= 1, B >= 2r)")
        # window i covers frames [i, i+T) of concat(tail or halo (2r), new)
        self._win_idx = torch.stack(
            [torch.arange(i, i + T) for i in range(windows)]).to(self.device)
        self._tail: Optional[List[torch.Tensor]] = None
        self._first_call = True         # the next restore_chunk is its clip's first

    def _upload(self, frames_u8) -> torch.Tensor:
        with span("pgt.upload"):
            t = torch.as_tensor(np.ascontiguousarray(frames_u8))
            if self.device.type == "cuda":
                # from pinned memory the copy is enqueued without waiting
                # for the steps ahead of it on the stream
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

    def _encode(self, frames_u8: torch.Tensor) -> List[torch.Tensor]:
        """[F, H, W, 3] uint8 -> flat per-frame features [pos, trunk, *skips]."""
        F = frames_u8.shape[0]
        with span("pgt.encode", frames=F):
            x = frames_u8.to(torch.float32) / 255.0
            pos, trunk, skips = self.model.encode_frames(x)
        profiling.count("pgt.frames_encoded", F)
        return [pos, trunk, *skips]

    def _restore(self, windows: List[torch.Tensor]):
        pos, trunk, *skips = windows
        out, _, _ = self.model.restore_windows(pos, trunk, tuple(skips), w=self.w,
                                               middle_only=True)
        with span("pgt.output"):
            out = out.to(torch.float32).clamp(0.0, 1.0)
            if self.readback == "yuv420":
                return _rgb_to_yuv420(out)
            return (out * 255.0).round().to(torch.uint8)

    def _sync(self) -> None:
        torch.cuda.synchronize(self.device)
        profiling.count("pgt.syncs")

    @torch.inference_mode()
    def _step(self, new_u8: torch.Tensor):
        if self.group is not None:
            return self._sharded_step(new_u8)
        ff_new = self._encode(new_u8)
        with span("pgt.gather"):
            ff = [torch.cat([a, b]) for a, b in zip(self._tail, ff_new)]
            windows = [a[self._win_idx] for a in ff]
            r = self.radius
            tail = [a[-2 * r:] if r else a[:0] for a in ff]
        out = self._restore(windows)
        self._tail = tail
        return out

    def _sharded_step(self, new_local: torch.Tensor):
        """One step on this rank of the group (the JAX package's
        ``_build_sharded_step``).  Rank k holds frames [k*Bl, (k+1)*Bl) of
        the chunk (Bl = B/n) and encodes only those.  Its windows need the
        2r frames before them: they come from the ring-left ranks, the last
        min(2r, Bl) frames' features of rank k-d for d = 1..D, D =
        ceil(2r/Bl) (more than one hop when Bl < 2r), except where the ring
        wraps: a prefix frame from before this chunk comes from the carried
        tail.  The rank restores its Bl windows; then the next tail (the
        chunk's last 2r frames) reaches every rank by a masked sum in which
        each frame's owner alone contributes.  The features cross ranks as
        their bytes, packed into one uint8 row per frame."""
        g, r = self.group, self.radius
        k, Bl = g.rank, self.batch // g.world
        ff_local = self._encode(new_local)
        packed, layout = _pack(ff_local)                   # [Bl, bytes]
        send_cnt = min(2 * r, Bl)
        depth = -(-2 * r // Bl)
        recvs = {d: P.ring_shift(packed[-send_cnt:], d, g) for d in range(1, depth + 1)}
        tail_packed, _ = _pack(self._tail)                 # [2r, bytes], replicated
        prefix = []
        for m in range(2 * r):
            # prefix slot m holds chunk frame k*Bl + m - 2r: a negative one
            # belongs to the previous chunk, at tail[k*Bl + m]
            o = m - 2 * r
            d_m = -(o // Bl)                               # ring-left distance
            if k >= d_m:
                prefix.append(recvs[d_m][o % Bl - (Bl - send_cnt)])
            else:
                prefix.append(tail_packed[k * Bl + m])
        ctx = [torch.cat([a, b]) for a, b in zip(_unpack(torch.stack(prefix), layout), ff_local)]
        out = self._restore([a[self._win_idx] for a in ctx])
        # the next tail: chunk frames B-2r .. B-1; frame B-2r+m is row p of
        # rank q's, and every other rank adds zeros in its place
        qp = [divmod(self.batch - 2 * r + m, Bl) for m in range(2 * r)]
        mine = torch.tensor([q == k for q, _ in qp], device=packed.device)
        rows = packed[torch.tensor([p for _, p in qp], device=packed.device)]
        self._tail = _unpack(P.masked_sum(rows, mine, g), layout)
        return out

    def reset(self):
        self._tail = None
        self._first_call = True

    def _order(self, op: int = _OP_STOP, shape=(0, 0)) -> Tuple[int, int, int]:
        """Rank 0 sends (op, H, W) to every rank; every rank returns what
        rank 0 sent (the other ranks' arguments are ignored)."""
        h = torch.tensor([op, *shape], dtype=torch.int64)
        P.broadcast_(h, self.group)
        got, H, W = (int(v) for v in h)
        return got, H, W

    def _expect(self, op: int, shape) -> Tuple[int, int]:
        got, H, W = self._order(op, shape if self.group.rank == 0 else (0, 0))
        if got != op:
            raise RuntimeError(f"rank {self.group.rank} was called for op {op}, "
                               f"rank 0 sent op {got}")
        return H, W

    def prime(self, first_frame: Optional[np.ndarray]):
        """Left padding: the first frame duplicated 2r times, its features
        cached as the tail.  With a group, rank 0's frame reaches every rank
        (the others pass None) and each encodes it."""
        if self.group is not None:
            H, W = self._expect(_OP_PRIME, first_frame.shape[:2] if first_frame is not None
                                else (0, 0))
            self._prime(first_frame, H, W)
        else:
            self._prime(first_frame)

    def _prime(self, first_frame, H: int = 0, W: int = 0):
        with span("pgt.prime"):
            if self.group is not None:
                f = (torch.as_tensor(np.ascontiguousarray(first_frame)) if self.group.rank == 0
                     else torch.empty((H, W, 3), dtype=torch.uint8))
                first_frame = P.broadcast_(f, self.group).numpy()
            with torch.inference_mode():
                self._tail = self._encode(self._upload(
                    np.repeat(first_frame[None], 2 * self.radius, axis=0)))
            if self.device.type == "cuda":
                self._sync()

    def _chunk(self, new_frames_u8, H: int = 0, W: int = 0):
        """One chunk: this process's step, or (with a group) rank 0's frames
        scattered, every rank's step, the outputs gathered on rank 0."""
        if self.group is None:
            return self._step(self._upload(new_frames_u8))
        g = self.group
        Bl = self.batch // g.world
        frames = torch.as_tensor(np.ascontiguousarray(new_frames_u8)) if g.rank == 0 else None
        out = self._step(P.scatter_rows(frames, (Bl, H, W, 3), torch.uint8, g))
        if self.readback == "yuv420":
            planes = [P.gather_rows(t, g) for t in out]
            return tuple(planes) if g.rank == 0 else None
        return P.gather_rows(out, g)

    def restore_chunk(self, new_frames_u8):
        """new_frames_u8 [B, H, W, 3] uint8 -> restored [B, H, W, 3] uint8 on
        the device (or YUV420 planes), returned without waiting for the
        device.  `prime()` must come first.  With a group, rank 0's output is
        the whole chunk's, gathered (on the host under gloo); the other ranks
        pass None and get None.  The first call after :meth:`reset` runs to
        its end on the device (``pgt.first_chunk_sync``)."""
        if self._tail is None:
            raise RuntimeError("call prime() before restore_chunk()")
        with span("pgt.call", frames=self.batch, root=True):
            H = W = 0
            if self.group is not None:
                H, W = self._expect(_OP_CHUNK, new_frames_u8.shape[1:3]
                                    if new_frames_u8 is not None else (0, 0))
            out = self._chunk(new_frames_u8, H, W)
            if self._first_call:
                self._first_call = False
                if self.device.type == "cuda":
                    with span("pgt.first_chunk_sync"):
                        self._sync()
            return out

    def _follow(self) -> dict:
        """A rank other than 0 in :meth:`restore_video`: prime and restore
        chunks as rank 0 orders, until it stops."""
        self.reset()
        steps = 0
        while True:
            op, H, W = self._order()
            if op == _OP_STOP:
                return {"frames": 0, "steps": steps}
            if op == _OP_PRIME:
                self._prime(None, H, W)
            elif op == _OP_CHUNK:
                self._chunk(None, H, W)
                steps += 1
            else:
                raise RuntimeError(f"rank 0 sent op {op}")

    def restore_video(self, input_path: Optional[str] = None,
                      output_path: Optional[str] = None,
                      progress: bool = False, frame_callback=None,
                      codec: str = "auto") -> dict:
        """Restore a video file into `output_path`, encoded by the native
        writer with `codec` ('auto' = libx265 CRF 18 hvc1, else libx264,
        else mpeg4; or 'libx265' / 'libx264' / 'mpeg4', with optional
        ':preset=' / ':params=' suffixes) or by OpenCV (mp4v).
        `frame_callback(index, rgb_u8)` runs per restored frame (readback
        'rgb' only).  Returns the frame count, wall seconds, frames/s,
        `startup_seconds` (prime and first chunk; the JAX package names it
        `compile_seconds`), steady frames/s, the `reader` and `writer`
        backends (`_describe`: under io_backend 'auto' a codec the native
        writer cannot open falls back to 'opencv:mp4v', with a warning when
        it was named) and `phases`: wall time of
        `decode`, `first_chunk` (the first chunk's dispatch, run to its end;
        the JAX package names it `compile`), `dispatch` (upload and enqueue
        of each later chunk), `readback` (the main thread's wait for a
        chunk's host copy) and `encode(threaded)` (the writer thread).
        With a group, rank 0 reads and writes the file (its stats are the
        file's) and each chunk runs across the ranks; every other rank calls
        this without paths and returns when rank 0 is done ({"frames": 0,
        "steps": chunks it took part in})."""
        if self.group is not None and self.group.rank != 0:
            return self._follow()
        yuv = self.readback == "yuv420"
        if yuv and frame_callback is not None:
            raise ValueError("frame_callback needs readback='rgb' "
                             "(yuv420 mode never materializes RGB on host)")
        timer = StageTimer("pgt.video.")
        reader = _open_reader(input_path, self.io_backend)
        B, r = self.batch, self.radius
        n_frames = 0
        pending: List = []     # (readback future, n_valid)
        startup = [0.0]        # the pgt.prime span and the clip's first pgt.call
        self.reset()
        t0 = time.perf_counter()

        # the CPU-bound encoder runs in a writer thread, overlapping the
        # device and the readback
        wq: "queue.Queue" = queue.Queue(maxsize=4)
        werr: List[BaseException] = []
        encode_s = [0.0]
        opened = [None]        # the writer's backend, once it is open

        def writer_main():
            writer = None
            try:
                while True:
                    frames = wq.get()
                    if frames is None:
                        break
                    te = time.perf_counter()
                    if yuv:
                        y, u, v = frames
                        if writer is None:
                            writer = _open_writer(output_path, reader.fps, y.shape[1:3],
                                                  "native", codec)
                            opened[0] = _describe(writer, codec)
                        for i in range(y.shape[0]):
                            writer.write_yuv420(y[i], u[i], v[i])
                    else:
                        for f in frames:
                            if writer is None:
                                writer = _open_writer(output_path, reader.fps, f.shape[:2],
                                                      self.io_backend, codec)
                                opened[0] = _describe(writer, codec)
                            writer.write(f)
                    encode_s[0] += time.perf_counter() - te
            except BaseException as e:  # surfaced after join
                werr.append(e)
            finally:
                if writer is not None:
                    writer.close()

        wthread = threading.Thread(target=writer_main, name="restore_video-writer", daemon=True)
        wthread.start()

        # device->host copies of chunk k overlap the dispatch and decode of
        # chunk k+1 and each other; `drain` only joins the future
        rb_pool = ThreadPoolExecutor(max_workers=2)
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def submit(dev_out, n_valid):
            outs = list(dev_out) if yuv else [dev_out]
            outs = [t[:n_valid] for t in outs]
            if not outs[0].is_cuda:     # the CPU, or a group's gather on the host
                return rb_pool.submit(lambda: [t.numpy() for t in outs]), n_valid
            # the copy waits for this step only, not for the steps enqueued
            # after it on the compute stream; the pool worker waits for the
            # copy, keeping the device tensors alive until it is done
            step_done = torch.cuda.Event()
            step_done.record()
            with torch.cuda.stream(copy_stream):
                copy_stream.wait_event(step_done)
                host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
                for h, t in zip(host, outs):
                    h.copy_(t, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(copy_stream)

            def fetch(keep=outs):
                copied.synchronize()
                return [h.numpy() for h in host]
            return rb_pool.submit(fetch), n_valid

        def put_to_writer(item):
            # a bounded put that re-checks the writer's health every second:
            # a writer that dies after a one-shot check would otherwise leave
            # this thread blocked on the full queue
            while True:
                if werr:
                    raise werr[0]
                try:
                    wq.put(item, timeout=1.0)
                    return
                except queue.Full:
                    continue

        def drain(entry):
            nonlocal n_frames
            fut, n_valid = entry
            with timer.stage("readback"):
                frames = fut.result()
            put_to_writer(tuple(frames) if yuv else frames[0])
            if frame_callback is not None:
                for f in frames[0]:
                    frame_callback(n_frames, f)
                    n_frames += 1
            else:
                n_frames += n_valid
            if progress and n_frames % 64 < n_valid:
                print(f"  {n_frames} frames...", flush=True)

        def flush(chunk, n_valid):
            # the first chunk's dispatch runs to its end (startup)
            first = self._first_call
            with timer.stage("first_chunk" if first else "dispatch"):
                out = self.restore_chunk(np.stack(chunk))
            if first:
                startup[0] += profiling.last("pgt.call").seconds
            pending.append(submit(out, n_valid))
            if len(pending) > self.inflight:
                drain(pending.pop(0))

        def signal_writer_stop():
            # bounded: a live writer frees a slot; a dead one needs no signal
            while wthread.is_alive():
                try:
                    wq.put(None, timeout=1.0)
                    return
                except queue.Full:
                    if werr:
                        return

        # prime() consumes frame 0; then every chunk of B new frames yields B
        # restored centers.  At stream end the q buffered frames owe q + r
        # more outputs, produced from chunks padded with the last frame.
        finished = False
        try:
            chunk: List[np.ndarray] = []
            last_frame = None
            reader_it = iter(reader)
            while True:
                with timer.stage("decode"):
                    frame = next(reader_it, None)
                if frame is None:
                    break
                if last_frame is None:
                    self.prime(frame)
                    startup[0] += profiling.last("pgt.prime").seconds
                    last_frame = frame
                    continue
                last_frame = frame
                chunk.append(frame)
                if len(chunk) == B:
                    flush(chunk, B)
                    chunk = []
            if last_frame is None:
                finished = True
                return {"frames": 0, "seconds": 0.0, "fps": 0.0}
            needed = len(chunk) + r
            while needed > 0:
                chunk.extend([last_frame] * (B - len(chunk)))
                n_valid = min(B, needed)
                flush(chunk, n_valid)
                needed -= n_valid
                chunk = []
            while pending:
                drain(pending.pop(0))
            finished = True
        finally:
            # every exit releases the decoder, the readback pool and the
            # writer thread; the success path waits for the encoder to
            # finish the file, an error path joins with a bound.  The other
            # ranks of a group are released on every exit; on an error
            # path that message may fail too, and the error in flight is
            # the one raised
            if self.group is not None:
                try:
                    self._order(_OP_STOP)
                except RuntimeError:
                    if finished:
                        raise
            rb_pool.shutdown(wait=finished, cancel_futures=not finished)
            reader.close()
            signal_writer_stop()
            wthread.join(timeout=None if finished else 60.0)
        if werr:
            raise werr[0]
        timer.totals["encode(threaded)"] = encode_s[0]
        timer.counts["encode(threaded)"] = 1
        dt = time.perf_counter() - t0
        startup = startup[0]
        steady = dt - startup if startup else dt
        steady_frames = max(n_frames - B, 0)
        return {"frames": n_frames, "seconds": dt,
                "fps": n_frames / dt if dt > 0 else 0.0,
                "startup_seconds": startup,
                "steady_fps": steady_frames / steady if steady > 0 else 0.0,
                "reader": _describe(reader), "writer": opened[0],
                "phases": timer.summary()}
