"""gn_ms_per_frame: the GroupNorm kernel pair's two kernels, by their exact
names, fall in the trace's "norm" group (out of the glue) and are summed
a traced frame; a trace without them reads nothing."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

import devtrace

KERNELS = ("group_norm_stats_kernel", "group_norm_apply_kernel")


def _metric():
    path = Path(__file__).resolve().parents[1] / "metrics" / "gn_ms_per_frame.py"
    spec = importlib.util.spec_from_file_location("gn_ms_per_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", KERNELS)
def test_kernels_are_norms_not_glue(name):
    assert devtrace.group_of(name) == "norm"


@pytest.mark.parametrize("kernels,frames,want", [
    ({"group_norm_stats_kernel": (0.002, 96), "group_norm_apply_kernel": (0.006, 96),
      "gn_silu_conv3x3_kernel": (1.0, 4), "vectorized_layer_norm_kernel": (1.0, 9)}, 8, 1.0),
    ({"group_norm_apply_kernel": (0.0016, 72)}, 16, 0.1),
    ({"vectorized_layer_norm_kernel": (0.5, 9)}, 8, None),
])
def test_gn_ms_per_frame(kernels, frames, want):
    run = SimpleNamespace(trace={"kernels": kernels}, traced_frames=frames)
    got = _metric().read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_gn_ms_per_frame_without_a_trace():
    assert _metric().read(SimpleNamespace(trace=None, traced_frames=0)) is None
