"""Tracing and profiling helpers: per-stage wall timing, a device trace,
codebook health."""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block, written to `log_dir` as a Chrome
    trace (TensorBoard's profiler plugin and Perfetto read it), with the
    card's activity where there is a card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StageTimer:
    """Per-stage wall timing for pipelines.  `sync`, if given, runs before
    a stage's clock stops (e.g. `torch.cuda.synchronize` to charge a
    stage's device work to it)."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_ms": 1e3 * v / self.counts[k]}
                for k, v in self.totals.items()}


def codebook_stats(codes: np.ndarray, n_embed: int) -> dict:
    """Codebook health metrics: usage ratio + perplexity."""
    flat = np.asarray(codes).reshape(-1)
    counts = np.bincount(flat, minlength=n_embed).astype(np.float64)
    p = counts / max(counts.sum(), 1)
    nz = p[p > 0]
    perplexity = float(np.exp(-(nz * np.log(nz)).sum()))
    return {"usage_ratio": float((counts > 0).mean()),
            "perplexity": perplexity}
