"""The program's stage spans (``pgtformer_tpu_torch/utils/profiling.py``),
matched to the window's calls, for the per-layer metrics that read them.

The program stamps each span's start and end on ``time.perf_counter_ns()``,
the clock of the ``time.perf_counter()`` that stamps a call's ``t_submit``
and ``t_dispatched``; a span belongs to the call whose ``[t_submit,
t_dispatched]`` holds it.  Host readers take the window's calls that the
profiler did not record, as ``dispatch_ms`` does; device readers take the
traced calls, whose spans carry a CUDA event at each end (the stage's
device interval), and divide by the traced frames.  Each gives None where
the program keeps no spans, where its ring dropped spans at or after the
start of a call read, or where a call read lacks the stage.
"""

from __future__ import annotations

import bisect
from typing import List, Optional


def tracer():
    """The program's tracer module, or None where it has none."""
    try:
        from pgtformer_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("spans", "dropped")):
        return None
    return profiling


def _ns(t: float) -> int:
    return round(t * 1e9)


def in_calls(records: List[dict], name: str) -> Optional[List[list]]:
    """For each record, the spans named `name` inside its entry call; None
    where any call has none, or the ring dropped spans at or after a
    call's start."""
    tr = tracer()
    if tr is None or not records:
        return None
    dropped_until = tr.dropped()[1]
    found = sorted((s for s in tr.spans() if s.name == name), key=lambda s: s.t0)
    starts = [s.t0 for s in found]
    out = []
    for rec in records:
        lo, hi = _ns(rec["t_submit"]), _ns(rec["t_dispatched"])
        if lo <= dropped_until:
            return None
        i = bisect.bisect_left(starts, lo)
        got = []
        while i < len(found) and found[i].t0 <= hi:
            if found[i].t1 <= hi:
                got.append(found[i])
            i += 1
        if not got:
            return None
        out.append(got)
    return out


def untraced(run) -> List[dict]:
    return [rec for rec in run.untraced_records if rec.get("in_window")]


def traced(run) -> Optional[List[dict]]:
    """The traced calls, or None where any is missing from the window's."""
    if run.trace is None:
        return None
    first, n = run.traffic["trace_first_call"], run.traffic["trace_calls"]
    recs = [rec for rec in run.records if first <= rec["call"].index < first + n]
    return recs if recs and len(recs) == run.traced_calls else None


def host_ms(run, name: str) -> Optional[float]:
    """Mean host ms a call of the spans named `name`, untraced calls."""
    per_call = in_calls(untraced(run), name)
    if per_call is None:
        return None
    return sum(s.t1 - s.t0 for got in per_call for s in got) / 1e6 / len(per_call)


def device_ms_per_frame(run, name: str) -> Optional[float]:
    """Device ms of the spans named `name` over the traced calls, a frame."""
    recs = traced(run)
    if recs is None or not run.traced_frames:
        return None
    per_call = in_calls(recs, name)
    if per_call is None:
        return None
    ms = [s.device_ms for got in per_call for s in got]
    if any(m is None for m in ms):
        return None
    return sum(ms) / run.traced_frames


def clip_start_ms(run) -> Optional[float]:
    """Mean host ms from the start of each untraced clip's ``pgt.prime``
    (made just before its first call) to the end of its first call's
    ``pgt.first_chunk_sync``."""
    firsts = [rec for rec in untraced(run) if rec["call"].starts_clip]
    syncs = in_calls(firsts, "pgt.first_chunk_sync")
    tr = tracer()
    if syncs is None or tr is None:
        return None
    primes = sorted((s for s in tr.spans() if s.name == "pgt.prime"), key=lambda s: s.t1)
    ends = [s.t1 for s in primes]
    ms = []
    for rec, got in zip(firsts, syncs):
        i = bisect.bisect_right(ends, _ns(rec["t_submit"])) - 1
        if i < 0:
            return None
        ms.append((got[-1].t1 - primes[i].t0) / 1e6)
    return sum(ms) / len(ms)
