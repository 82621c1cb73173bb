"""The port's tracer (`utils/profiling.py`) and its spans in the serving
step: the span tree of one `VideoRestorer.restore_chunk` and of one
`CodeFormer.forward`, outputs unchanged under a profiler, nothing made for
the profiler while none records, the `pgt.*` names in a CPU profiler's
trace, the ring's overflow and `restore_video`'s stats read from spans.
Small geometries on the CPU."""

import collections
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pgtformer_tpu_torch.utils.profiling as T
from pgtformer_tpu_torch.models.codeformer import CodeFormer
from pgtformer_tpu_torch.pipeline import VideoRestorer
from tests.test_torch_common import one_torch_thread, small_configs  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 4
CALL_STAGES = ["pgt.upload", "pgt.encode", "pgt.gather", "pgt.attn", "pgt.transformer",
               "pgt.decode", "pgt.output"]
CF_STAGES = ["pgt.encode", "pgt.transformer", "pgt.decode"]


class SmallCodeFormer(CodeFormer):
    """CodeFormer at 64x64 (tests/test_torch_vqgan_family.py's tables)."""
    FUSE_ENCODER_BLOCK = {"64": 1, "32": 3, "16": 5, "8": 8}
    FUSE_GENERATOR_BLOCK = {"8": 5, "16": 7, "32": 9, "64": 11}
    CHANNELS = {"8": 128, "16": 64, "32": 64, "64": 32}


CF_KW = dict(dim_embd=32, n_head=4, n_layers=2, codebook_size=64, latent_size=64,
             connect_list=("16", "32", "64"), img_size=64, nf=32, ch_mult=(1, 2, 2, 4),
             res_blocks=1, attn_resolutions=(8,), emb_dim=32, w=0.5, adain=True)


@pytest.fixture(scope="module")
def restorer():
    return VideoRestorer(None, small_configs()[1], w=1.0, batch_windows=B,
                         dtype=torch.float32, device="cpu", seed=3)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).integers(0, 256, (1 + 2 * B, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def codeformer():
    return SmallCodeFormer(**CF_KW, generator=torch.Generator().manual_seed(4)).eval()


@pytest.fixture(scope="module")
def faces():
    return torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(6)) * 2 - 1


def _clip(r, frames):
    """prime + two calls; (outputs, the spans they closed, counters before, after)."""
    before = T.summary()["counters"]
    n0 = len(T.spans())
    r.reset()
    r.prime(frames[0])
    outs = [r.restore_chunk(frames[1 + i * B:1 + (i + 1) * B]).clone() for i in range(2)]
    return outs, T.spans()[n0:], before, T.summary()["counters"]


def test_restore_chunk_span_tree(restorer, frames):
    """prime is a call of its own (upload, encode); each restore_chunk is one
    `pgt.call` holding every stage, in order, under one call id."""
    T.reset()
    _, got, before, after = _clip(restorer, frames)
    assert [s.name for s in got] == (["pgt.upload", "pgt.encode", "pgt.prime"]
                                     + 2 * (CALL_STAGES + ["pgt.call"]))
    prime, calls = got[2], [got[10], got[18]]
    assert prime.parent is None and prime.call == prime.id
    assert all(s.parent == prime.id and s.call == prime.id for s in got[:2])
    for k, call in enumerate(calls):
        stages = got[3 + 8 * k:10 + 8 * k]
        assert call.parent is None and call.call == call.id and call.frames == B
        assert all(s.parent == call.id and s.call == call.id for s in stages)
        assert all(call.t0 <= s.t0 <= s.t1 <= call.t1 for s in stages)
        assert all(a.t1 <= b.t0 for a, b in zip(stages, stages[1:]))
    assert calls[0].call != calls[1].call
    assert {s.thread for s in got} == {threading.get_ident()}
    assert got[1].frames == 2 * restorer.radius and got[4].frames == B
    assert after["pgt.frames_encoded"] - before.get("pgt.frames_encoded", 0) == \
        2 * restorer.radius + 2 * B
    assert after["pgt.windows_restored"] - before.get("pgt.windows_restored", 0) == 2 * B
    assert "pgt.syncs" not in after             # the CPU never synchronizes
    assert all(s.device_ms is None for s in got)


def test_codeformer_span_tree(codeformer, faces):
    """A forward with no span open is a `pgt.call` of its own; inside an
    open span its stages hang under that span."""
    T.reset()
    with torch.inference_mode():
        codeformer(faces)
        with T.span("outer") as outer:
            codeformer(faces)
    got = T.spans()
    assert [s.name for s in got] == CF_STAGES + ["pgt.call"] + CF_STAGES + ["outer"]
    call = got[3]
    assert call.parent is None and call.frames == 2
    assert all(s.parent == call.id and s.call == call.id for s in got[:3])
    assert got[0].frames == 2
    assert all(s.parent == outer.id and s.call == outer.id for s in got[4:7])
    assert T.summary()["counters"]["pgt.frames_encoded"] == 4


def test_outputs_bit_equal_under_a_profiler(restorer, frames, codeformer, faces):
    plain, _, _, _ = _clip(restorer, frames)
    with torch.inference_mode():
        cf_plain = codeformer(faces)[0]
    with profile(activities=[ProfilerActivity.CPU]):
        traced, _, _, _ = _clip(restorer, frames)
        with torch.inference_mode():
            cf_traced = codeformer(faces)[0]
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert torch.equal(cf_plain, cf_traced)


def test_stage_names_in_the_profilers_trace(restorer, frames, codeformer, faces):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _clip(restorer, frames)
        with torch.inference_mode():
            codeformer(faces)
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events())
    # prime, two restore_chunk calls and one CodeFormer forward
    assert {n: names[n] for n in CALL_STAGES + ["pgt.call", "pgt.prime"]} == {
        "pgt.upload": 3, "pgt.encode": 4, "pgt.gather": 2, "pgt.attn": 2,
        "pgt.transformer": 3, "pgt.decode": 3, "pgt.output": 2, "pgt.call": 3,
        "pgt.prime": 1}


class _Counting:
    """Stands in for the profiler's host op and `torch.cuda.Event`; counts them."""
    made = collections.Counter()

    def __init__(self, *a, **k):
        self.kind = "event" if k.get("enable_timing") else "range"
        self.made[self.kind] += 1
        self.at = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def record(self, stream=None):
        self.made["recorded"] += 1
        self.at = self.made["recorded"]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_nothing_made_for_the_profiler_while_none_records(monkeypatch, restorer, frames):
    """No range and no event while no profiler records; under one, a range
    and a pair of events (were CUDA in use) a span, read as the span's
    device interval."""
    _Counting.made.clear()
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(torch.cuda, "Event", _Counting)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _, got, _, _ = _clip(restorer, frames)
    assert len(got) == 19 and not _Counting.made
    assert all(s.device_ms is None for s in got)
    with profile(activities=[ProfilerActivity.CPU]):
        _, got, _, _ = _clip(restorer, frames)
    assert _Counting.made["range"] == len(got) == 19
    assert _Counting.made["event"] == _Counting.made["recorded"] == 2 * 19
    assert all(s.device_ms is not None and s.device_ms > 0 for s in got)


def test_ring_overflow_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(T, "RING", 8)
    monkeypatch.setattr(T, "_ring", collections.deque(maxlen=8))
    monkeypatch.setattr(T, "_dropped", [0, 0])
    closed = []
    for i in range(20):
        with T.span(f"s{i}") as s:
            pass
        closed.append(s)
    assert [s.name for s in T.spans()] == [f"s{i}" for i in range(12, 20)]
    assert T.dropped() == (12, closed[11].t1)
    assert T.summary()["dropped"] == 12
    T.reset()
    assert T.dropped() == (0, 0) and T.spans() == []


def test_counters_summary_last_and_reset():
    T.reset()
    T.count("pgt.x", 3)
    T.count("pgt.x")
    for _ in range(2):
        with T.span("a"):
            with T.span("b") as b:
                assert T.current() is b
    assert T.current() is None
    s = T.summary()
    assert s["counters"] == {"pgt.x": 4} and s["dropped"] == 0
    assert {k: v["count"] for k, v in s["spans"].items()} == {"a": 2, "b": 2}
    assert s["spans"]["a"]["total_s"] >= s["spans"]["b"]["total_s"] > 0
    assert T.last("b") is b and T.last("c") is None
    T.reset()
    assert T.summary() == {"spans": {}, "counters": {}, "dropped": 0}


def test_root_spans_threads_and_errors():
    """`root=True` starts a call inside an open span; each thread keeps its
    own stack; a span that raises still closes."""
    T.reset()
    with T.span("outer") as outer:
        with T.span("inner-call", root=True) as call:
            with T.span("stage") as stage:
                pass
    assert call.parent == outer.id and call.call == call.id != outer.call
    assert stage.parent == call.id and stage.call == call.id
    seen = {}

    def other():
        with T.span("elsewhere") as s:
            seen["span"] = s
            seen["last"] = T.last("outer")
    with T.span("held"):
        th = threading.Thread(target=other)
        th.start()
        th.join()
    s = seen["span"]
    assert s.parent is None and s.thread != outer.thread and seen["last"] is None
    with pytest.raises(ValueError):
        with T.span("fails"):
            raise ValueError
    assert T.current() is None and T.last("fails").t1 >= T.last("fails").t0


def test_stage_timer_stages_are_spans():
    T.reset()
    timer = T.StageTimer("pgt.video.")
    for name in ("decode", "dispatch", "decode"):
        with timer.stage(name) as sp:
            assert T.current() is sp
    assert [s.name for s in T.spans()] == ["pgt.video.decode", "pgt.video.dispatch",
                                           "pgt.video.decode"]
    summ = timer.summary()
    assert summ["decode"]["count"] == 2
    assert summ["decode"]["total_s"] == sum(s.seconds for s in T.spans()
                                            if s.name == "pgt.video.decode")


def test_restore_video_reads_startup_from_spans(tmp_path, restorer):
    """`startup_seconds` is the `pgt.prime` span and the first `pgt.call`;
    the phases keep their keys and are the `pgt.video.*` spans."""
    import cv2
    path = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 32))
    rng = np.random.default_rng(8)
    for _ in range(1 + 2 * B):
        w.write(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    w.release()
    restorer.io_backend = "opencv"
    T.reset()
    stats = restorer.restore_video(path, str(tmp_path / "out.avi"))
    got = T.spans()
    assert set(stats["phases"]) == {"decode", "first_chunk", "dispatch", "readback",
                                    "encode(threaded)"}
    prime = [s for s in got if s.name == "pgt.prime"]
    calls = [s for s in got if s.name == "pgt.call"]
    assert len(prime) == 1 and len(calls) == 3 and stats["frames"] == 1 + 2 * B
    assert stats["startup_seconds"] == prime[0].seconds + calls[0].seconds
    first = [s for s in got if s.name == "pgt.video.first_chunk"]
    assert len(first) == 1 and calls[0].parent == first[0].id
    assert calls[0].call == calls[0].id                 # a call of its own
    assert stats["phases"]["first_chunk"]["total_s"] == first[0].seconds
    assert stats["phases"]["dispatch"]["count"] == sum(
        s.name == "pgt.video.dispatch" for s in got) == 2


def test_threads_lose_no_span_or_count(monkeypatch):
    """More threads than cores closing spans into a small ring, with the
    interpreter switching threads as often as it can: every span is kept
    or counted as dropped, every count is added, each thread's spans nest
    under its own."""
    import sys
    monkeypatch.setattr(T, "RING", 1000)
    monkeypatch.setattr(T, "_ring", collections.deque(maxlen=1000))
    monkeypatch.setattr(T, "_dropped", [0, 0])
    monkeypatch.setattr(T, "_counters", {})
    n_threads, n_spans = 16, 2000
    bad = []

    def work():
        for _ in range(n_spans // 2):
            with T.span("outer") as outer:
                with T.span("inner") as inner:
                    T.count("pgt.n")
            if inner.parent != outer.id or inner.call != outer.id:
                bad.append(inner)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not bad
    assert T.dropped()[0] + len(T.spans()) == n_threads * n_spans
    assert len(T.spans()) == 1000
    assert T.summary()["counters"] == {"pgt.n": n_threads * n_spans // 2}
