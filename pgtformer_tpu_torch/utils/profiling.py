"""The port's tracer (spans and counters), per-stage wall timing built on
it, and codebook health.

Every stage of the serving step runs inside a :func:`span`.  A span keeps
its name, its parent span, the call it belongs to, its thread and its
start and end on ``time.perf_counter_ns()`` (the clock of
``time.perf_counter``).  A span opened where no span is open on its
thread, or with ``root=True``, starts a call: every span opened inside it
carries its id.  Closed spans go into a ring of the last `RING`; once it is
full the oldest are dropped and counted (``summary()["dropped"]``).  This
record is always on and costs about a microsecond a span.

While a ``torch.profiler`` records, each span also opens a host op of its
name (as ``record_function`` does, but in the scope of an ATen op, which
the profiler does not mirror onto the device), so that the profiler's
trace names the device's work and idle time by stage on its own clock,
and, where CUDA is in use, records a CUDA event at each end on the
current stream: the stage's device interval, from the device reaching
the span's start to its finishing the span's last operation
(:attr:`Span.device_ms`, resolved when read).  While none records, a span
creates neither.

:func:`count` adds to a counter; :func:`spans`, :func:`last`,
:func:`summary` and :func:`reset` read and clear the tracer.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import numpy as np
import torch

RING = 65536

_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = [0, 0]           # spans dropped, the latest end (ns) among them
_counters: dict = {}
_lock = threading.Lock()    # the ring's fill test and append, the counters
_local = threading.local()
_ids = itertools.count(1)
_get_ident = threading.get_ident
_recording = torch._C._autograd._profiler_enabled


class Span:
    """``with span(name):`` traces the block (module docstring); `frames`
    is what the span carries for the frames it handles; `root` starts a
    call inside an open span.  After it closes, `t0`/`t1` are its host
    start and end in ns."""

    __slots__ = ("name", "frames", "root", "id", "parent", "call", "thread", "t0", "t1",
                 "_rf", "_ev")

    def __init__(self, name: str, frames: Optional[int] = None, root: bool = False):
        self.name, self.frames, self.root = name, frames, root

    def __enter__(self) -> "Span":
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.id = i = next(_ids)
        if stack:
            up = stack[-1]
            self.parent, self.call = up.id, i if self.root else up.call
        else:
            self.parent, self.call = None, i
        self.thread = _get_ident()
        stack.append(self)
        self._rf = self._ev = None
        if _recording():
            # a host op of the span's name (FUNCTION scope, as an ATen op):
            # a record_function range (USER_SCOPE) would also be mirrored
            # as a device-side annotation, read as device work by tools
            # that cannot tell annotations from kernels
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
            if torch.cuda.is_initialized():
                self._ev = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                self._ev[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            if self._ev is not None:
                self._ev[1].record()
            self._rf.__exit__(*exc)
            self._rf = None
        _local.stack.pop()
        with _lock:
            if len(_ring) == RING:
                _dropped[0] += 1
                t = _ring[0].t1
                if t > _dropped[1]:
                    _dropped[1] = t
            _ring.append(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def device_ms(self) -> Optional[float]:
        """The span's device interval, ms (waits for it); None where no
        profiler recorded the span or it ran without CUDA."""
        if self._ev is None:
            return None
        self._ev[1].synchronize()
        return self._ev[0].elapsed_time(self._ev[1])


span = Span


def current() -> Optional[Span]:
    """The innermost span open on this thread, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def spans() -> List[Span]:
    """The closed spans in the ring, oldest first (in the order they closed)."""
    with _lock:
        return list(_ring)


def dropped() -> tuple:
    """(spans dropped from the ring, the latest end in ns among them)."""
    with _lock:
        return tuple(_dropped)


def last(name: str) -> Optional[Span]:
    """The newest closed span named `name` opened on this thread, or None."""
    me = _get_ident()
    for s in reversed(spans()):
        if s.name == name and s.thread == me:
            return s
    return None


def summary() -> dict:
    """{"spans": {name: {"count", "total_s", "mean_ms"}} over the ring,
    "counters": {name: n}, "dropped": n}."""
    totals: dict = {}
    for s in spans():
        t = totals.setdefault(s.name, [0, 0])
        t[0] += 1
        t[1] += s.t1 - s.t0
    return {"spans": {k: {"count": n, "total_s": ns / 1e9, "mean_ms": ns / 1e6 / n}
                      for k, (n, ns) in totals.items()},
            "counters": dict(_counters), "dropped": dropped()[0]}


def reset() -> None:
    """Empty the ring and the counters (open spans close into the new ring)."""
    with _lock:
        _ring.clear()
        _counters.clear()
        _dropped[:] = [0, 0]


class StageTimer:
    """Per-stage wall timing for pipelines: each stage is a span named
    `prefix` + its name, summed here by name.  `sync`, if given, runs
    before a stage's span closes (e.g. `torch.cuda.synchronize` to charge
    a stage's device work to it)."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        with span(self.prefix + name) as sp:
            yield sp
            if sync is not None:
                sync()
        self.totals[name] = self.totals.get(name, 0.0) + sp.seconds
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
