"""The comparison that decides ``correct``: the program's uint8 frames
against the plain reference's, each number beside its limit.

The reference runs each sampled call's inputs in float32 (the reference)
and in bfloat16 throughout (the yardstick); the numbers (``frame_numbers``)
measure the program's gap from the reference in units of the yardstick's,
in least significant bits of uint8 (LSB).  A configuration's file names
the numbers compared and their limits; a run is correct where each is at
most its limit.  The control puts the reference, its products' operands
in fp8, in the program's place (``benchmark/calibrate.py``,
``benchmark/tests``); the benchmark's own runs never run it.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict, List

import numpy as np


FRAME_LOG = None     # a list, where calibrate.py keeps each frame's gaps


def reference_model(cls, model_cfg, state_dict, device, dtype=None):
    """The reference model `cls` with the run's weights on `device`, in
    float32 (TF32 off) or `dtype`."""
    import torch
    from reference import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = cls(model_cfg)
    return layers.load_reference(model, state_dict, device, dtype or torch.float32)


@contextlib.contextmanager
def fp8_products():
    """The control's precision: the reference with both operands of every
    product rounded to fp8 e4m3 (one scale a tensor) and back."""
    from reference import layers
    layers.GEMM_ROUNDING = layers.fp8_e4m3
    try:
        yield
    finally:
        layers.GEMM_ROUNDING = None


def judge_outputs(reference, make_step, keys, samples, limits,
                  control: bool = False) -> List[dict]:
    """The comparison for one run.  `reference(dtype)` builds the reference
    model, `make_step(model)(key)` is its uint8 output for one sampled
    call's inputs, `keys` each sample's key, `samples` (call, the program's
    uint8 output) with the call's `n_valid`.  The reference runs on each
    distinct input in float32 (the reference) and in bfloat16 throughout
    (the yardstick: the gap that computing at the served precision opens on
    these weights and inputs); for the control, also in float32 with its
    products in fp8, in the program's place."""
    import torch
    if not samples:
        # no call of the window finished: nothing of it can be judged
        return [{"name": "window_unjudged", "value": 1, "limit": 0, "ok": False}]
    distinct = sorted(set(keys))
    step = make_step(reference(torch.float32))
    ref = {k: step(k) for k in distinct}
    if control:
        with fp8_products():
            ctl = {k: step(k) for k in distinct}
    del step
    step = make_step(reference(torch.bfloat16))
    yard = {k: step(k) for k in distinct}
    del step
    cut = lambda table: [table[k][:call.n_valid] for k, (call, _) in zip(keys, samples)]
    prog = cut(ctl) if control else [out for _, out in samples]
    want = cut(ref)
    numbers = frame_numbers(prog, want, cut(yard))
    print("[bench] outputs:", output_numbers(prog), "reference:", output_numbers(want),
          "numbers:", {k: round(v, 4) for k, v in numbers.items()}, file=sys.stderr, flush=True)
    return checks(numbers, limits)


def _gaps(prog: List[np.ndarray], ref: List[np.ndarray]) -> np.ndarray:
    """|prog - ref| in LSB, [frames, values]."""
    rows = []
    for p, r in zip(prog, ref):
        if p.shape != r.shape:
            raise ValueError(f"output shape {p.shape}, reference {r.shape}")
        d = np.abs(p.astype(np.int16) - r.astype(np.int16))
        rows.append(d.reshape(d.shape[0], -1))
    return np.concatenate(rows).astype(np.float32)


def _low(d: np.ndarray, share: float) -> np.ndarray:
    """Per frame, the mean of the smaller `share` of its gaps: the part of
    the frame that the code choices did not move."""
    k = int(d.shape[1] * share)
    return np.partition(d, k, axis=1)[:, :k].mean(1)


def frame_numbers(prog: List[np.ndarray], ref: List[np.ndarray],
                  yard: List[np.ndarray]) -> Dict[str, float]:
    """The numbers of the sampled frames (lists of uint8 arrays [n, H, W,
    3], call by call): the program's gaps from the float32 reference in
    LSB, and in units of the yardstick's (`yard`, the reference in bf16).

    A code choice that flips between two near-tied codes moves a patch of
    the frame by tens of LSB, and both sides flip some; the rest of the
    frame carries the rounding.  The numbers pooled over the frames are
    steady from seed to seed:

    * ``over_16_ratio``: the share of values whose gap passes 16 LSB, over
      the yardstick's share (no less than half a percent), over the whole
      of every frame: a fault in part of every frame (wrong codes on some
      of the tokens, a window border or a region decoded wrong) moves it;
    * ``low_3q_ratio``, ``low_half_ratio``: the mean over the frames of
      each frame's better three quarters (half) of gaps, over the
      yardstick's: rounding, with how far these weights amplify it taken
      out;
    * ``mean_ratio``: the mean gap over every value, over the yardstick's.

    ``p95_matched_ratio`` (each frame's better-half gap over the
    yardstick's on the same frame, no less than the yardstick's mean, at
    the 95th percentile over the frames) would single out one wrong frame
    in sixteen, but a flip now and then moves a whole frame of a sound run
    (better half 14 LSB against the yardstick's 0.2), so its readings
    swing from seed to seed; it is printed, not compared."""
    d, y = _gaps(prog, ref), _gaps(yard, ref)
    low, ylow = _low(d, 0.5), _low(y, 0.5)
    low3, ylow3 = _low(d, 0.75), _low(y, 0.75)
    floor = 0.05        # LSB: a yardstick that moved nothing still sets a unit
    unit = max(float(ylow.mean()), floor)
    matched = low / np.maximum(ylow, unit)
    far, yfar = float((d > 16).mean()), float((y > 16).mean())
    if FRAME_LOG is not None:
        FRAME_LOG.append({"mean": d.mean(1).tolist(), "yard_mean": y.mean(1).tolist(),
                          "low": low.tolist(), "yard_low": ylow.tolist(),
                          "low3q": low3.tolist(), "yard_low3q": ylow3.tolist()})
    return {"over_16_ratio": far / max(yfar, 0.005),
            "low_3q_ratio": float(low3.mean()) / max(float(ylow3.mean()), floor),
            "low_half_ratio": float(low.mean()) / unit,
            "p95_matched_ratio": float(np.percentile(matched, 95)),
            "mean_ratio": float(d.mean()) / max(float(y.mean()), floor),
            "mean_lsb": float(d.mean()),
            "yardstick_mean_lsb": float(y.mean()),
            "low_half_mean_lsb": float(low.mean()),
            "yardstick_low_half_mean_lsb": float(ylow.mean()),
            "worst_frame_mean_lsb": float(d.mean(1).max()),
            "frames": float(d.shape[0])}


def output_numbers(prog: List[np.ndarray]) -> Dict[str, float]:
    """What the frames look like: their mean, and the share of values at
    0 or 255 (clamped)."""
    v = np.concatenate([p.reshape(-1) for p in prog])
    return {"out_mean": float(v.mean()), "out_clamped_share": float(((v == 0) | (v == 255)).mean())}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """One entry per number with a limit: ok where it is at most the limit.
    Without any limit (a configuration not yet calibrated) every number is
    printed with the limit null, and the run is not correct."""
    out = [{"name": k, "value": numbers[k], "limit": lim, "ok": numbers[k] <= lim}
           for k, lim in limits.items()]
    if not out:
        out = [{"name": k, "value": v, "limit": None, "ok": False} for k, v in numbers.items()]
    return out
