"""The readers of the program's stage spans (``spans.py`` and the metrics
that call it), on a synthetic run and ring; then on a small traced CPU run
of each cell, through the program's own tracer."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import spans
from conftest import small_spec

BENCH = Path(__file__).resolve().parents[1]
SPAN_METRICS = {"call_host_ms": "pgt.call", "encode_host_ms": "pgt.encode",
                "attn_host_ms": "pgt.attn", "transformer_host_ms": "pgt.transformer",
                "decode_host_ms": "pgt.decode", "encode_dev_ms_per_frame": "pgt.encode",
                "attn_dev_ms_per_frame": "pgt.attn",
                "transformer_dev_ms_per_frame": "pgt.transformer",
                "decode_dev_ms_per_frame": "pgt.decode", "clip_start_ms": None}
S = 1_000_000_000


def _span(name, t0_s, ms, device_ms=None):
    t0 = round(t0_s * S)
    return SimpleNamespace(name=name, t0=t0, t1=t0 + round(ms * 1e6), device_ms=device_ms)


class Ring:
    def __init__(self, items, dropped_until=0):
        self.items, self.until = items, dropped_until

    def spans(self):
        return list(self.items)

    def dropped(self):
        return (1 if self.until else 0, self.until)


def _rec(index, t_submit, t_dispatched, in_window=True, starts_clip=False, n_valid=8):
    call = SimpleNamespace(index=index, starts_clip=starts_clip, n_valid=n_valid)
    return {"call": call, "t_submit": t_submit, "t_dispatched": t_dispatched,
            "in_window": in_window}


def _run():
    """Calls 0-1 untraced in the window (0 starts a clip), 2-3 traced, 4
    untraced and past the window's end; each call's stage spans last 1 ms
    more than the call's index, their device intervals 10 ms more."""
    recs = [_rec(0, 10.0, 10.5, starts_clip=True), _rec(1, 11.0, 11.5),
            _rec(2, 12.0, 12.5), _rec(3, 13.0, 13.5), _rec(4, 14.0, 14.5, in_window=False)]
    items = [_span("pgt.prime", 9.5, 200.0), _span("pgt.prime", 9.0, 5.0)]
    for i, rec in enumerate(recs):
        t = rec["t_submit"]
        traced = i in (2, 3)
        items.append(_span("pgt.call", t + 0.001, 400.0 + i))
        for k, name in enumerate(("pgt.encode", "pgt.attn", "pgt.transformer", "pgt.decode")):
            items.append(_span(name, t + 0.01 + 0.05 * k, 1.0 + i,
                               10.0 + i if traced else None))
        if rec["call"].starts_clip:
            items.append(_span("pgt.first_chunk_sync", t + 0.3, 100.0))
    items.append(_span("pgt.encode", 11.6, 50.0))       # between calls: nobody's
    run = SimpleNamespace(records=[r for r in recs if r["in_window"]],
                          untraced_records=[r for r in recs if r["call"].index not in (2, 3)],
                          trace={"window_s": 1.0}, traced_calls=2, traced_frames=16,
                          traffic={"trace_first_call": 2, "trace_calls": 2})
    return run, items


@pytest.fixture
def ring(monkeypatch):
    run, items = _run()
    r = Ring(items)
    monkeypatch.setattr(spans, "tracer", lambda: r)
    return run, r


def _read(name, run):
    import harness
    return harness.load_module(BENCH / "metrics" / f"{name}.py", f"m_{name}").read(run)


def test_host_readers_take_the_untraced_calls_in_the_window(ring):
    run, _ = ring
    assert _read("call_host_ms", run) == pytest.approx(400.5)
    for name in ("encode", "attn", "transformer", "decode"):
        assert _read(f"{name}_host_ms", run) == pytest.approx(1.5)   # calls 0 and 1


def test_device_readers_take_the_traced_calls(ring):
    run, _ = ring
    for name in ("encode", "attn", "transformer", "decode"):
        assert _read(f"{name}_dev_ms_per_frame", run) == pytest.approx((12.0 + 13.0) / 16)


def test_clip_start_runs_from_the_prime_to_the_first_sync(ring):
    run, _ = ring
    assert _read("clip_start_ms", run) == pytest.approx(1000 * (10.3 - 9.5) + 100.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_none_where_the_ring_dropped_spans_in_the_calls(ring, name):
    run, r = ring
    assert _read(name, run) is not None
    r.until = round(10.5 * S)              # overlaps an untraced call ...
    if name.endswith("_dev_ms_per_frame"):
        assert _read(name, run) is not None    # ... but no traced one
        r.until = round(12.2 * S)
    assert _read(name, run) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_none_where_a_call_lacks_the_stage(ring, name):
    """The stage taken out of one call that the reader reads: untraced call
    1, traced call 3, or the clip's first call."""
    run, r = ring
    stage = SPAN_METRICS[name] or "pgt.first_chunk_sync"
    at = 13.0 if name.endswith("_dev_ms_per_frame") else 10.0 if stage.endswith("sync") else 11.0
    r.items = [s for s in r.items if not (s.name == stage and
                                          round(at * S) <= s.t0 <= round((at + 0.5) * S))]
    assert _read(name, run) is None


def test_none_without_device_intervals_or_the_tracer(ring, monkeypatch):
    run, r = ring
    for s in r.items:
        s.device_ms = None
    assert _read("encode_dev_ms_per_frame", run) is None
    assert _read("encode_host_ms", run) is not None
    run.trace = None
    assert _read("decode_dev_ms_per_frame", run) is None
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert all(_read(n, run) is None for n in SPAN_METRICS)


def test_each_reader_is_a_per_layer_entry():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (BENCH / "metrics" / f"{name}.py").is_file()
        assert m["moves"] == "frames_per_s" and m["source"] == "program_span"
        video_only = name.startswith("attn_") or name == "clip_start_ms"
        assert m["workloads"] == (["pgt-video-b8"] if video_only
                                  else ["pgt-video-b8", "codeformer-faces-b16"])


@pytest.mark.parametrize("workload", ["pgt-video-b8", "codeformer-faces-b16"])
def test_a_traced_cpu_run_reads_the_programs_spans(workload):
    """Through the program's tracer: every host reader of the cell has a
    number, and they agree with each other; the CPU gives no device
    intervals and never synchronizes (so no clip start)."""
    import harness
    from pgtformer_tpu_torch.utils import profiling
    profiling.reset()
    spec = small_spec(workload)
    torch.manual_seed(0)
    result, _ = harness.run_cell(spec, 2 ** 34 + 5, 6.0, True, torch.device("cpu"),
                                 time.perf_counter())
    got = {k: v["value"] for k, v in result["metrics"].items()}
    host = {m["name"] for m in spec.per_layer if m["name"].endswith("_host_ms")}
    assert len(host) == (5 if workload == "pgt-video-b8" else 4) and host <= set(got)
    assert not {n for n in got if n.endswith("_dev_ms_per_frame") or n == "clip_start_ms"}
    stages = sum(got[n] for n in host if n != "call_host_ms")
    assert 0 < stages <= got["call_host_ms"] <= got["dispatch_ms"]
