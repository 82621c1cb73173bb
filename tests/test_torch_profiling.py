"""The port's profiling helpers (`utils/profiling.py`) against the JAX
package's, and the two host tools built on the file path
(`profile_stages.py`, `bench_encode.py`) at a small size on the CPU."""

import itertools
import json
import os
import time

import numpy as np
import pytest

import pgtformer_tpu.utils.profiling as J
import pgtformer_tpu_torch.utils.profiling as T
from tests.test_torch_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_stage_timer_matches_jax(monkeypatch):
    """The same stages on the same (stubbed) clock give the same summary;
    `sync` runs inside the stage.  (The port's stages are spans, on
    `perf_counter_ns`: the same clock in ns.)"""
    summaries = []
    for mod in (T, J):
        clock = itertools.count(0.0, 0.25)
        clock_ns = itertools.count(0, 250_000_000)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock_ns))
        synced = []
        timer = mod.StageTimer()
        for name in ("decode", "dispatch", "decode", "readback"):
            with timer.stage(name, sync=lambda: synced.append(1) if name == "readback" else None):
                pass
        monkeypatch.undo()
        summaries.append(timer.summary())
        assert synced == [1]
    assert summaries[0] == summaries[1]
    assert summaries[0]["decode"] == {"total_s": 0.5, "count": 2, "mean_ms": 250.0}


@pytest.mark.parametrize("n_embed,kind", [(16, "uniform"), (64, "sparse"), (8, "single")])
def test_codebook_stats_match_jax(n_embed, kind):
    rng = np.random.default_rng(n_embed)
    codes = {"uniform": rng.integers(0, n_embed, (4, 8, 8)),
             "sparse": rng.integers(0, n_embed // 4, (2, 16, 16)),
             "single": np.full((3, 4), 5)}[kind]
    assert T.codebook_stats(codes, n_embed) == J.codebook_stats(codes, n_embed)


def test_profile_stages_small_on_the_cpu(monkeypatch):
    """Every stage timed; the stages composed give the whole step's frames
    (checked inside `profile`, which raises otherwise)."""
    import pgtformer_tpu_torch.config as tcfg
    from pgtformer_tpu_torch import profile_stages
    from tests.test_torch_common import small_configs
    monkeypatch.setattr(tcfg, "RELEASE_PGTFORMER", small_configs()[1])
    p = profile_stages.profile(batch=2, iters=1, device="cpu")
    assert p["device"] == "cpu" and p["res"] == 32
    assert len(p["stages_ms"]) == 8
    assert all(ms > 0 for ms in p["stages_ms"].values()) and p["step_ms"] > 0


def test_bench_encode_small():
    from pgtformer_tpu_torch import bench_encode
    from pgtformer_tpu_torch.io.native import NativeVideoUnavailable, load_library
    try:
        load_library()
    except NativeVideoUnavailable as e:
        pytest.skip(f"native video io unavailable: {e}")
    out = bench_encode.bench(frames=4, size=32, codecs=("mpeg4", "libnotacodec"))
    ok, missing = out["rows"]
    assert ok["codec"] == "mpeg4" and ok["fps"] > 0 and ok["kbits_per_frame"] > 0
    assert missing["codec"] == "libnotacodec" and "cannot open" in missing["error"]


def test_bench_encode_out_writes_the_rows(monkeypatch, tmp_path, capsys):
    """`--out` writes `bench`'s dict as JSON, as the JAX tool does; a codec
    that cannot open (or every one, where the native library cannot be
    built) is a row with its error."""
    from pgtformer_tpu_torch import bench_encode
    monkeypatch.setattr(bench_encode, "CASES", ("mpeg4", "libnotacodec"))
    path = tmp_path / "rows.json"
    assert bench_encode.main(["--frames", "2", "--size", "32", "--out", str(path)]) == 0
    with open(path) as f:
        out = json.load(f)
    assert (out["frames"], out["size"], out["host_cores"]) == (2, 32, os.cpu_count())
    assert [r["codec"] for r in out["rows"]] == ["mpeg4", "libnotacodec"]
    assert "error" in out["rows"][1]
    assert all("error" in r or (r["fps"] > 0 and r["kbits_per_frame"] > 0)
               for r in out["rows"])
    assert f"wrote {path}" in capsys.readouterr().out
