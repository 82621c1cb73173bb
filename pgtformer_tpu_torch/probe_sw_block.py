"""Where the time of one K1 (``sw_block``) slab pass goes, on the card.

Builds ``csrc/sw_block.cu`` a second time with ``-DSW_PROBE`` (into
``build/kernels/libsw_block-SW_PROBE.so``): thread 0 of CTA 0 then adds the
clock cycles of each phase of its slab passes to counters in shared memory
(a clock read and a shared-memory add at each phase boundary) and hands
them to device counters when its passes are done; the normal build has no
probe.  At each of the serving step's three layer shapes (shifted) it times
the normal build (CUDA events, 10 launches after a warm-up), then runs the
probed build once and prints the cycles of one slab pass, averaged over the
passes of CTA 0 (a persistent CTA walks many): the wait for the slab's
rows, LN1, the q/k/v GEMMs, the attention, proj, LN2, fc1, the request
for the next slab's rows and fc2, and, inside the GEMMs, the
cycles spent waiting for weight boxes, issuing products, waiting for the
products of a k-step (before its slot is released) and for the last
product of a chunk, and in the epilogues::

    python -m pgtformer_tpu_torch.probe_sw_block [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

PHASES = {7: "waiting for the slab's rows", 0: "LN1", 1: "q/k/v GEMMs", 2: "attention",
          3: "proj", 4: "LN2", 5: "fc1", 11: "requesting the next slab's rows", 6: "fc2"}
GEMM_PARTS = {8: "waiting for weight boxes", 9: "issuing products",
              14: "waiting for a k-step's products", 10: "waiting for a chunk's last product",
              16: "q/k/v epilogues", 17: "proj epilogues", 18: "fc1 epilogues (erf GELU)",
              19: "fc2 epilogues"}
PASSES = 15
COUNTERS = 24
SHAPES = [(8, 3, 128, 128, 256), (8, 3, 64, 64, 256), (8, 3, 32, 32, 512)]


def read(lib) -> list:
    buf = (ctypes.c_ulonglong * COUNTERS)()
    if lib.sw_block_probe_read(buf) != 0:
        raise RuntimeError("sw_block_probe_read failed")
    return list(buf)


def _time(fn, iters: int = 10) -> float:
    import torch
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=str, default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_sw_block: no CUDA device", file=sys.stderr)
        return 2
    from pgtformer_tpu_torch.nn.blocks import SWTransformerBlock, init_weights
    from pgtformer_tpu_torch.ops import sw_block as sb
    probed = sb._lib("SW_PROBE")
    probed.sw_block_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    results = []
    for i, shape in enumerate(SHAPES):
        B, T, H, W, C = shape
        g = torch.Generator().manual_seed(100 + i)
        blk = init_weights(SWTransformerBlock(C, 8, T, (4, 4), (0, 0), mlp_ratio=1.0), g)
        w = blk.cuda().kernel_weights(torch.device("cuda"))
        x = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(i),
                        device="cuda").to(torch.bfloat16)
        ms = _time(lambda: sb.sw_block(x, w, (2, 2)))
        sb.launch_5d(probed, x, w, (2, 2))
        torch.cuda.synchronize()
        read(probed)
        sb.launch_5d(probed, x, w, (2, 2))
        torch.cuda.synchronize()
        cyc = read(probed)
        passes = max(1, cyc[PASSES])
        per = {k: cyc[k] / passes for k in list(PHASES) + list(GEMM_PARTS)}
        total = sum(per[k] for k in PHASES)
        row = {"shape": list(shape), "ms": ms, "cycles": total, "passes": cyc[PASSES],
               "phases": {PHASES[k]: per[k] for k in PHASES},
               "gemm_parts": {GEMM_PARTS[k]: per[k] for k in GEMM_PARTS}}
        results.append(row)
        print(f"[probe] x{list(shape)} shift(2, 2): {row['ms']:.4f} ms; CTA 0, one slab pass "
              f"(mean of {cyc[PASSES]}): {total:.0f} cycles = "
              + ", ".join(f"{n} {c:.0f} ({c / total:.1%})" for n, c in row["phases"].items())
              + "; inside the GEMMs: "
              + ", ".join(f"{n} {c:.0f}" for n, c in row["gemm_parts"].items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
