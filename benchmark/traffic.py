"""The one traffic generator: a traffic file's parameters -> the calls of a
closed loop.

A traffic file (``benchmark/traffic/<name>.json``) holds:

* ``batch``: frames handed to the entry call at once;
* ``inflight``: calls left on the device before the oldest is read back;
* ``warmup_calls``: calls made before the window, as the window makes them
  (for clips, from a clip's ``prime``), counted as set-up;
* ``clip_frames``: frames per clip, for a model that carries state across
  the calls of a clip (each clip starts with a ``prime``; its last call is
  padded with the clip's last frame, as ``restore_video`` pads it), or
  ``null`` for independent images;
* ``pool``: distinct images made from the seed and handed out in turn
  (images only: a clip replays its own ``clip_frames`` frames);
* ``trace_first_call``, ``trace_calls``: the calls the profiler records in
  a ``--trace 1`` run (for clips, a whole clip from its ``prime``);
* ``sample``: calls of the window whose outputs are judged, drawn from the
  seed (reservoirs: ``first`` of the clips' first calls, ``last`` of their
  last calls, ``any`` of all calls).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np


@dataclass(frozen=True)
class Call:
    index: int                  # in the run, from 0 (warm-up calls included)
    clip: int                   # the clip (or round through the pool) it belongs to
    chunk: int                  # its place in the clip
    frames: tuple               # pool indices handed to the entry call
    n_valid: int                # outputs that are frames (the rest pad)
    starts_clip: bool
    ends_clip: bool


def load(path: Path) -> dict:
    with open(path) as f:
        t = json.load(f)
    for key in ("batch", "inflight", "clip_frames", "trace_first_call", "trace_calls", "sample"):
        if key not in t:
            raise ValueError(f"traffic file {path}: no {key!r}")
    return t


def pool_size(t: dict) -> int:
    return t["clip_frames"] if t["clip_frames"] else t["pool"]


def clip_plan(clip_frames: int, batch: int, radius: int) -> List[tuple]:
    """(frames, n_valid) of each call of one clip, as ``restore_video``
    issues them: frame 0 primes the state, every B further frames make a
    call, and the q frames left at the end owe q + r outputs, made by calls
    padded with the last frame."""
    calls, chunk = [], []
    for f in range(1, clip_frames):
        chunk.append(f)
        if len(chunk) == batch:
            calls.append((tuple(chunk), batch))
            chunk = []
    needed = len(chunk) + radius
    while needed > 0:
        chunk = chunk + [clip_frames - 1] * (batch - len(chunk))
        n = min(batch, needed)
        calls.append((tuple(chunk), n))
        needed -= n
        chunk = []
    return calls


def calls(t: dict, radius: int) -> Iterator[Call]:
    """The endless sequence of calls of traffic `t`; `radius` is the
    model's temporal half-window r (clips only)."""
    B = t["batch"]
    i = 0
    clip = 0
    if t["clip_frames"]:
        plan = clip_plan(t["clip_frames"], B, radius)
        while True:
            for k, (frames, n) in enumerate(plan):
                yield Call(i, clip, k, frames, n, k == 0, k == len(plan) - 1)
                i += 1
            clip += 1
    pool = t["pool"]
    per_round = pool // B
    while True:
        k = i % per_round
        start = k * B
        yield Call(i, i // per_round, k, tuple(range(start, start + B)), B, False, False)
        i += 1


class Reservoirs:
    """Uniform samples, drawn from `seed`, of the calls completed in the
    window, kept as they complete: one reservoir per kind of call."""

    def __init__(self, sizes: dict, seed: int):
        self.rng = np.random.default_rng([seed, 0x5A3])
        self.sizes = dict(sizes)
        self.seen = {k: 0 for k in sizes}
        self.kept = {k: [] for k in sizes}

    def offer(self, call: Call) -> Optional[List[str]]:
        """The reservoirs that take `call` (evicting another at random), or None."""
        took = []
        for kind, size in self.sizes.items():
            if kind == "first" and not call.starts_clip:
                continue
            if kind == "last" and not call.ends_clip:
                continue
            self.seen[kind] += 1
            slot = (len(self.kept[kind]) if len(self.kept[kind]) < size
                    else int(self.rng.integers(0, self.seen[kind])))
            if slot < size:
                if slot == len(self.kept[kind]):
                    self.kept[kind].append(call.index)
                else:
                    self.kept[kind][slot] = call.index
                took.append(kind)
        return took or None

    def chosen(self) -> List[int]:
        return sorted({i for kept in self.kept.values() for i in kept})


def make_frames(seed: int, n: int, res: int, device, block: int = 32) -> np.ndarray:
    """`n` seeded uint8 frames [n, res, res, 3], made on `device` and
    returned in host memory: per frame a smooth random field (a 16x16 grid
    of colours, bilinearly upsampled), a finer 64x64 layer, and pixel
    noise.  Each frame is drawn on its own, so neighbouring frames share
    nothing and no two windows of a clip hold the same content."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for s in range(0, n, block):
        m = min(block, n - s)
        up = lambda t: F.interpolate(t, size=(res, res), mode="bilinear", align_corners=False)
        x = (up(torch.rand(m, 3, 16, 16, generator=g, device=device))
             + 0.25 * up(torch.rand(m, 3, 64, 64, generator=g, device=device) - 0.5)
             + 0.04 * torch.randn(m, 3, res, res, generator=g, device=device))
        x = (x.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1)
        out.append(x.contiguous().cpu())
    return torch.cat(out).numpy()
