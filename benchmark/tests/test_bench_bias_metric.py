"""bias_ms_per_frame: the conv-bias kernels, by their exact names, fall in
the trace's "elementwise/other" group (they count as glue, so the glue
metric shows the net change) and are summed a traced frame; a trace
without them reads nothing."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

import devtrace

KERNELS = ("bias_add_kernel", "bias_residual_add_kernel")


def _metric():
    path = Path(__file__).resolve().parents[1] / "metrics" / "bias_ms_per_frame.py"
    spec = importlib.util.spec_from_file_location("bias_ms_per_frame", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", KERNELS)
def test_kernels_are_glue(name):
    assert devtrace.group_of(name) == devtrace.OTHER


@pytest.mark.parametrize("kernels,frames,want", [
    ({"bias_add_kernel": (0.004, 60), "bias_residual_add_kernel": (0.004, 27),
      "group_norm_apply_kernel": (1.0, 48), "elementwise_kernel": (1.0, 9)}, 8, 1.0),
    ({"bias_residual_add_kernel": (0.0016, 40)}, 16, 0.1),
    ({"group_norm_apply_kernel": (0.5, 48)}, 8, None),
])
def test_bias_ms_per_frame(kernels, frames, want):
    run = SimpleNamespace(trace={"kernels": kernels}, traced_frames=frames)
    got = _metric().read(run)
    assert got == (None if want is None else pytest.approx(want))


def test_bias_ms_per_frame_without_a_trace():
    assert _metric().read(SimpleNamespace(trace=None, traced_frames=0)) is None
