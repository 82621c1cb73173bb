"""The comparison that decides ``correct``, driven end to end on the CPU at
the small geometries (the look for a card skipped): a sound run comes out
correct; the control and each fault that the cell can have
(``benchmark/faults.py``, planted in the port's timed path) come out not
correct, under the limits of the configuration's file."""

import time

import pytest
import torch

import faults
from conftest import small_spec

SEED = 2 ** 35 + 17
FAULTS = [(w, k) for w, d in (("pgt-video-b8", "pgt_video"),
                              ("codeformer-faces-b16", "codeformer_faces"))
          for k in faults.KINDS[d]]


def _run(workload, control=False):
    import harness
    spec = small_spec(workload)
    torch.manual_seed(0)
    result, checks = harness.run_cell(spec, SEED, 3.0, False, torch.device("cpu"),
                                      time.perf_counter(), control=control)
    assert checks and all(c["limit"] is not None for c in checks)
    return result, spec


@pytest.mark.parametrize("workload", ["pgt-video-b8", "codeformer-faces-b16"])
def test_sound_run_is_correct_and_control_is_not(workload):
    result, spec = _run(workload, control=True)
    limits = spec.config["correct"]["limits"]
    assert result["correct"], result["limits"]
    assert any(result["control"][k] > lim for k, lim in limits.items()), result["control"]


@pytest.mark.parametrize("workload,kind", FAULTS)
def test_faults_are_not_correct(workload, kind):
    with faults.plant(small_spec(workload).config["driver"], kind):
        result, _ = _run(workload)
    assert not result["correct"], result["limits"]
