"""Readings for the limits of ``correct``: the program's numbers on many
seeds and the control's on some, each seed a short window of the cell at
its own size and load, all in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--fault codes] [--seconds 8] \\
        [--out chiprun_out/calibrate.jsonl]

Each seed prints one JSON line: the program's numbers (judge.py), the
control's where asked for, the run's end-to-end metrics and each judged
frame's gaps.  With
``--fault``, the fault of that name (faults.py) is planted in the program
for every seed: its readings are the program's numbers.  The
benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import faults  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.clear_plan_environment()
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    # every number of judge.py, each without a limit: these are its readings
    spec.config["correct"]["limits"] = {}
    control = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    with contextlib.ExitStack() as planted:
        if args.fault:
            planted.enter_context(faults.plant(spec.config["driver"], args.fault))
        for seed in (int(s) for s in args.seeds.split(",")):
            read(args, spec, seed, control, out)
    return 0


def read(args, spec, seed: int, control: set, out) -> None:
    """One seed's line: a short window of the cell, judged."""
    import torch
    judge.FRAME_LOG = []
    t0 = time.perf_counter()
    result, checks = harness.run_cell(spec, seed, args.seconds, False,
                                      torch.device("cuda", 0), t0, control=seed in control)
    line = {"workload": args.workload, "seed": seed, "fault": args.fault,
            "program": {c["name"]: c["value"] for c in checks},
            "control": result.get("control"),
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "seconds": time.perf_counter() - t0,
            # each frame's gaps, LSB: the program's, then the control's
            "frames": [{k: [round(v, 3) for v in vs] for k, vs in f.items()}
                       for f in judge.FRAME_LOG]}
    print(json.dumps(line), flush=True)
    if out:
        out.write(json.dumps(line) + "\n")
        out.flush()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
