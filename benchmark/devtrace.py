"""Reduction of a torch.profiler trace to what the per-layer metrics read.

``collect`` turns the profiler's raw (kineto) events into device intervals
(kernels, copies, sets) and host intervals (ATen ops, CUDA runtime calls,
the benchmark's own ``bench.*`` spans), on one clock.  ``reduce`` then takes
the traced window between the ``bench.window_begin`` and
``bench.window_end`` spans and gives:

* ``busy_s``: the union of the device intervals inside the window.  A
  union, not a sum of self times: the readback copies run on a second
  stream beside the kernels, and a sum would count the overlap twice;
* ``groups_s``: device seconds of the kernels by group (``GROUPS``,
  ``profile_step.py``'s, with cuBLAS's ``nvjet`` kernels put among the
  GEMMs), copies and sets left out;
* ``kernels``: {kernel name: (seconds, launches)};
* ``idle_gaps``: the device's idle time, each gap of 10 us or more named
  by the innermost interval of the main thread (the one that opened the
  window) that covers its middle, summed by that name; the shorter gaps
  pooled under one name.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

GROUPS = (("sw_block_pair (K4)", ("sw_block_pair_kernel",)),
          ("sw_block_tokens (K3)", ("sw_block_tokens_kernel",)),
          ("sw_block (K1)", ("sw_block_kernel",)),
          ("dense_mha (K2/K6)", ("dense_mha_kernel",)),
          ("vq_nearest (K5)", ("vq_nearest_kernel", "code_sqnorm_kernel")),
          ("gn_silu_conv3x3 (K7)", ("gn_silu_conv3x3_kernel",)),
          ("subpixel_up_conv3x3 (K8)", ("subpixel_up_conv3x3_kernel",)),
          ("conv (cuDNN)", ("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad")),
          ("gemm", ("gemm", "cutlass", "cublas", "nvjet")),
          ("norm", ("norm",)),
          ("copy/layout", ("copy", "transpose", "cat", "index", "gather",
                           "elementwise_kernel_with_index")),
          )
OTHER = "elementwise/other"
BEGIN, END = "bench.window_begin", "bench.window_end"
SHORT_GAP_NS = 10_000       # shorter idle gaps are pooled, not named


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return OTHER


def _is_transfer(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


def _activity(e) -> Optional[str]:
    f = getattr(e, "activity_type", None)
    try:
        return str(f()) if f is not None else None
    except Exception:   # an older binding without it
        return None


def collect(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device intervals, host intervals) of a stopped torch.profiler
    profile: (start_ns, end_ns, name, x), x for a device interval True for
    a copy or set, for a host interval its thread."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            act = (_activity(e) or "").lower()
            if "annotation" in act or name.startswith("bench.") or t <= s:
                continue
            dev.append((s, t, name, _is_transfer(name)))
        else:
            host.append((s, t, name, e.start_thread_id()))
    return dev, host


def union(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of [s, t) intervals clipped to [lo, hi), as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, t in sorted((max(s, lo), min(t, hi)) for s, t in intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return [tuple(iv) for iv in out]


def gaps(busy: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The parts of [lo, hi) that the sorted disjoint `busy` leaves free."""
    out, at = [], lo
    for s, t in busy:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if at < hi:
        out.append((at, hi))
    return out


def name_gap(gap: Tuple[int, int], host: List[tuple], starts: List[int],
             scan: int = 4000) -> str:
    """The innermost host interval that covers the gap's middle (`host`
    one thread's (start, end, name), sorted by start, `starts` its starts;
    the `scan` intervals that start last before the middle are searched)."""
    mid = (gap[0] + gap[1]) // 2
    best = None
    i = bisect.bisect_right(starts, mid)
    for s, t, name in host[max(0, i - scan):i]:
        if mid < t and (best is None or t - s < best[1] - best[0]):
            best = (s, t, name)
    return best[2] if best else "(no host op)"


def reduce(dev: List[tuple], host: List[tuple]) -> Dict:
    """The window's numbers (module docstring)."""
    begins = [(s, tid) for s, _, n, tid in host if n == BEGIN]
    ends = [t for _, t, n, _ in host if n == END]
    if not (begins and ends):
        raise RuntimeError("the trace holds no window spans")
    (lo, main), hi = min(begins), max(ends)
    inside = [(max(s, lo), min(t, hi), n, x) for s, t, n, x in dev if t > lo and s < hi]
    busy = union([(s, t) for s, t, _, _ in inside], lo, hi)
    groups: Dict[str, float] = {}
    kernels: Dict[str, List] = {}
    for s, t, name, transfer in inside:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (t - s) * 1e-9
        k[1] += 1
        if not transfer:
            g = group_of(name)
            groups[g] = groups.get(g, 0.0) + (t - s) * 1e-9
    idle: Dict[str, float] = {}
    host = sorted((s, t, n) for s, t, n, tid in host if tid == main)
    starts = [s for s, _, _ in host]
    for gp in gaps(busy, lo, hi):
        name = (name_gap(gp, host, starts) if gp[1] - gp[0] >= SHORT_GAP_NS
                else f"(gaps under {SHORT_GAP_NS // 1000} us)")
        idle[name] = idle.get(name, 0.0) + (gp[1] - gp[0]) * 1e-9
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(t - s for s, t in busy) * 1e-9,
            "groups_s": groups,
            "kernels": {n: (v[0], v[1]) for n, v in kernels.items()},
            "idle_gaps": idle}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
