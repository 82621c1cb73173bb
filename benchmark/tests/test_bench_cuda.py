"""On the card, at each cell's own size: a short window of the cell with
each fault of faults.py planted in the timed path comes out
not correct, and the control's reading lies above the limit.  Skips without
a card; on the card:

    python -m pytest -q -p no:cacheprovider -m cuda benchmark/tests/test_bench_cuda.py -s
"""

import time

import pytest
import torch

import faults
from test_bench_correctness import FAULTS

SEED = 2 ** 34 + 101


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _run(workload, device, control=False):
    import harness
    harness.clear_plan_environment()
    spec = harness.load_spec(workload)
    result, _ = harness.run_cell(spec, SEED, 4.0, False, device, time.perf_counter(),
                                 control=control)
    print(workload, result["limits"], result.get("control"))
    return result, spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pgt-video-b8", "codeformer-faces-b16"])
def test_cell_at_size_is_correct_and_control_is_not(workload, card):
    result, spec = _run(workload, card, control=True)
    assert result["correct"], result["limits"]
    limits = spec.config["correct"]["limits"]
    assert any(result["control"][k] > lim for k, lim in limits.items())


# One face in sixteen inverted ("altered" in the faces cell) moves the
# pooled numbers to about their limits at this size (2.0-2.7 against 2.2 and
# 2.45); no per-frame number separates the control from sound runs by the
# margin a limit needs, so it is read by calibrate.py --fault altered, not
# asserted here (PERF.md)
AT_SIZE = [f for f in FAULTS if f != ("codeformer-faces-b16", "altered")]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,kind", AT_SIZE)
def test_faults_at_size_are_not_correct(workload, kind, card):
    import harness
    with faults.plant(harness.load_spec(workload).config["driver"], kind):
        result, _ = _run(workload, card)
    assert not result["correct"], result["limits"]
