"""The benchmark's engine: find a cell's files by name, set the system up,
run the closed loop for the window, judge the outputs, print the result.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own and is found through ``BENCHMARK.json``:

* a cell (``workloads``) names a configuration and a traffic mix;
* the configuration's ``file`` (``benchmark/configs/<name>.json``) holds
  the model's sizes as run, the served dtype, the weight rules and the
  ``driver``: ``benchmark/drivers/<driver>.py``, the adapter to the port's
  entry call, which also holds the check of its outputs;
* the traffic mix is ``benchmark/traffic/<name>.json`` (``traffic.py``);
* each metric is ``benchmark/metrics/<name>.py``, whose ``read(run)``
  returns its value, or None where the run has nothing for it to read.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import devtrace
import traffic as traffic_mod

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pgtformer_tpu")


class Clock:
    """Seconds of each phase of a set-up, in `phases`."""

    def __init__(self):
        self.t = time.perf_counter()
        self.phases: Dict[str, float] = {}

    def __call__(self, phase: str) -> None:
        now = time.perf_counter()
        self.phases[phase] = round(now - self.t, 3)
        self.t = now


class Refused(Exception):
    """A run that may print no result (exit code 2)."""


def load_module(path: Path, name: str):
    if not path.is_file():
        raise Refused(f"{path.relative_to(ROOT)} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell `workload` with its configuration, traffic and metrics."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    bench_dir = root / "benchmark"
    tr = traffic_mod.load(bench_dir / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return SimpleNamespace(cell=cell, config=config, traffic=tr, end_to_end=e2e,
                           per_layer=layer, bench_dir=bench_dir)


def clear_plan_environment() -> List[str]:
    """Drop every PGT_* variable, so that the program runs its default plans."""
    gone = sorted(k for k in os.environ if k.startswith("PGT_"))
    for k in gone:
        del os.environ[k]
    return gone


def set_cache_dirs() -> None:
    """Kernel and extension caches at fixed places inside the checkout (the
    port builds its kernels into build/kernels/ of the checkout itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:      # noqa: BLE001 - the reading is a note only
        return f"not read ({type(e).__name__})"


class Loop:
    """The closed loop: each call is handed to the entry, its output copied
    to pinned host memory on a side stream (as ``restore_video`` does) and
    fetched by a pool thread, which notes when it is there; at most
    `inflight` calls stay unfetched.  (On the CPU, which only the tests
    use, the output is cloned.)"""

    def __init__(self, torch, system, inflight: int, on_done, device):
        self.torch, self.system, self.inflight = torch, system, inflight
        self.cuda = device.type == "cuda"
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.pool = ThreadPoolExecutor(max_workers=2)
        self.pending = collections.deque()
        self.on_done = on_done
        self.span = contextlib.nullcontext

    def submit(self, call) -> dict:
        torch = self.torch
        rec = {"call": call}
        if call.starts_clip:
            with self.span("bench.prime"):
                self.system.start_clip(call)
        with self.span("bench.call"):
            rec["t_submit"] = time.perf_counter()
            out = self.system.call(call)
            rec["t_dispatched"] = time.perf_counter()
        out = out[:call.n_valid]
        if not self.cuda:
            host = out.clone()
            rec["future"] = self.pool.submit(lambda: (time.perf_counter(), host))
        else:
            with self.span("bench.readback"):
                step_done = torch.cuda.Event()
                step_done.record()
                with torch.cuda.stream(self.copy_stream):
                    self.copy_stream.wait_event(step_done)
                    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    # a waiting pool thread sleeps rather than spins, and
                    # leaves the host's cores to the program
                    copied = torch.cuda.Event(blocking=True)
                    copied.record(self.copy_stream)

            def fetch(keep=out):
                copied.synchronize()
                return time.perf_counter(), host
            rec["future"] = self.pool.submit(fetch)
        self.pending.append(rec)
        while len(self.pending) > self.inflight:
            self.drain_one()
        return rec

    def drain_one(self) -> None:
        rec = self.pending.popleft()
        with self.span("bench.readback_wait"):
            rec["t_done"], host = rec.pop("future").result()
        self.on_done(rec, host)

    def drain(self) -> None:
        while self.pending:
            self.drain_one()

    def close(self) -> None:
        self.drain()
        self.pool.shutdown(wait=True)


def note(*a) -> None:
    print("[bench]", *a, file=sys.stderr, flush=True)


def run(args, t_start: float) -> int:
    """One run of `args.workload` on the card; returns the exit code."""
    gone = clear_plan_environment()
    set_cache_dirs()
    spec = load_spec(args.workload)
    import torch
    note(f"torch imported {time.perf_counter() - t_start:.2f} s after the start")
    chips = spec.cell["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise Refused(f"the cell asks for {chips} CUDA device(s), "
                      f"torch.cuda.is_available()={torch.cuda.is_available()}, {have} found")
    if gone:
        note("cleared from the environment:", " ".join(gone))
    result, checks = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start)
    # what the reference, the judge and the metric readers loaded after the
    # window counts too
    found = forbidden_modules()
    if found:
        raise Refused("modules of the JAX package or JAX are loaded: " + ", ".join(found))
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"{c['name']} {c['value']} limit {c['limit']} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr, flush=True)
    return 0


def run_cell(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False):
    """Set up, warm up, run the window, judge: (result, checks).  With
    `control`, the result also holds the control's numbers (judge.py)."""
    import torch
    cuda = device.type == "cuda"
    chips = spec.cell["chips"]
    card = power_limit() if cuda else "cpu"
    if cuda:
        torch.zeros(1, device=device)
    note(f"the card read and its context made {time.perf_counter() - t_start:.2f} s after the start")
    driver = load_module(spec.bench_dir / "drivers" / f"{spec.config['driver']}.py",
                         f"bench_driver_{spec.config['driver']}")
    t_sys = time.perf_counter()
    system = driver.System(spec.config, spec.traffic, seed, device)
    note(f"set-up: to the driver {t_sys - t_start:.2f} s, the system "
         f"{time.perf_counter() - t_sys:.2f} s {system.phases}")
    tr = spec.traffic
    radius = system.radius

    # warm-up: the cell's own calls, as the window makes them; then nothing
    # is left running
    warm = Loop(torch, system, tr["inflight"], lambda rec, host: None, device)
    gen = traffic_mod.calls(tr, radius)
    for _ in range(tr["warmup_calls"]):
        warm.submit(next(gen))
    warm.close()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    set_up_s = time.perf_counter() - t_start
    note(f"set-up {set_up_s:.3f} s; card {card}")

    # the window: calls until `seconds` have passed (and, traced, until the
    # traced calls are done); a call counts where its output is in host
    # memory before the window closes
    done: List[dict] = []
    kept: Dict[int, object] = {}
    sample = traffic_mod.Reservoirs(tr["sample"], seed)
    first, n_traced = tr["trace_first_call"], tr["trace_calls"]
    t0 = time.perf_counter()
    t_end = t0 + seconds

    def on_done(rec, host):
        rec["in_window"] = rec["t_done"] <= t_end
        done.append(rec)
        if rec["in_window"] and sample.offer(rec["call"]):
            kept[rec["call"].index] = (rec["call"], host.numpy().copy())
            chosen = set(sample.chosen())
            for i in [i for i in kept if i not in chosen]:
                del kept[i]

    # a traced run records `n_traced` calls from `first`, with the host's
    # ops (what the host was doing while the device idled) and the device's
    loop = Loop(torch, system, tr["inflight"], on_done, device)
    red = None
    issued = 0
    for call in traffic_mod.calls(tr, radius):
        traced = trace and first <= call.index < first + n_traced
        if time.perf_counter() >= t_end and not traced:
            break
        if trace and call.index == first:
            prof = start_trace(torch, loop)
        loop.submit(call)
        issued += 1
        if trace and call.index == first + n_traced - 1:
            red = stop_trace(torch, loop, prof)
    loop.close()
    t_close = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise Refused("modules of the JAX package or JAX are loaded: " + ", ".join(found))

    counters = system.counters()
    flops, shapes = system.reference_work() if trace else (None, None)
    samples = [kept[i] for i in sample.chosen() if i in kept]
    system.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = system.judge(samples)
    note(f"judged {len(samples)} sampled calls in {time.perf_counter() - t_judge:.1f} s")
    control_checks = system.judge(samples, control=True) if control else None

    in_trace = lambda rec: first <= rec["call"].index < first + n_traced
    traced = [rec for rec in done if in_trace(rec)]
    run = SimpleNamespace(
        seconds=seconds, set_up_s=set_up_s, records=[rec for rec in done if rec["in_window"]],
        untraced_records=[rec for rec in done if not in_trace(rec)], trace=red,
        window_peak_bytes=window_peak, counters=counters, flops_per_call=flops,
        shapes=shapes, frames_per_call=tr["batch"], traced_calls=len(traced),
        traced_frames=sum(rec["call"].n_valid for rec in traced), card=card,
        config=spec.config, traffic=tr)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        reader = load_module(spec.bench_dir / "metrics" / f"{m['name']}.py",
                             f"bench_metric_{m['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is None:
            note(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and red is None:
        raise Refused("the window ended before the traced calls")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": max(setup_peak, window_peak),
                   "power_limit": card}
    result = {"correct": bool(checks) and all(c["ok"] for c in checks),
              "attempted": issued, "failed": issued - len(done),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = red["busy_s"]
        device_info["window_s"] = red["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, (s, _) in sorted(
                red["kernels"].items(), key=lambda kv: -kv[1][0])[:10]],
            "idle_gaps": devtrace.top(red["idle_gaps"])}
    if control:
        result["control"] = {c["name"]: c["value"] for c in control_checks}
    result["limits"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    slices = [0] * max(1, int(seconds // 5))
    for rec in run.records:
        slices[min(len(slices) - 1, int((rec["t_done"] - t0) // 5))] += rec["call"].n_valid
    note("frames/s in each 5 s of the window:", [round(n / 5, 1) for n in slices])
    note(f"window {seconds} s: {len(run.records)} calls completed in it, {issued} issued, "
         f"closed {t_close - t0:.2f} s after it opened; launches {counters}"
         + (f"; {flops / tr['batch'] / 1e12:.4f} TFLOP a frame" if flops else ""))
    return result, checks


def start_trace(torch, loop: Loop):
    """Profile from here on: drain what is in flight, start the profiler
    (the host's ops and the device's), open the window span, and let the
    loop mark its calls."""
    from torch.profiler import ProfilerActivity, profile
    loop.drain()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if loop.cuda else [])
    prof = profile(activities=acts)
    prof.start()
    loop.span = torch.profiler.record_function
    with torch.profiler.record_function("bench.window_begin"):
        pass
    return prof


def stop_trace(torch, loop: Loop, prof) -> dict:
    """Drain the traced calls, close the window span, stop the profiler and
    reduce its events (devtrace.py)."""
    loop.drain()
    with torch.profiler.record_function("bench.window_end"):
        pass
    loop.span = contextlib.nullcontext
    t0 = time.perf_counter()
    prof.stop()
    t1 = time.perf_counter()
    dev, host = devtrace.collect(prof)
    red = devtrace.reduce(dev, host)
    note(f"trace: {len(dev)} device and {len(host)} host intervals; window "
         f"{red['window_s']:.4f} s, device busy {red['busy_s']:.4f} s; profiler stop "
         f"{t1 - t0:.1f} s, reduction {time.perf_counter() - t1:.1f} s")
    return red
