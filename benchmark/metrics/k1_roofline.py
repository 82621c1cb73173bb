"""Kernel K1 (sw_block_kernel) against its roofline, %: the least time
the card could take for the shifted-window blocks of the traced calls
(roofline.sw_block_bound of each block the reference runs, at its shape)
over K1's device time in the trace.  Nothing where K1 did not run once per
reference block."""

import roofline


def read(run):
    if run.trace is None or not run.shapes or not run.shapes["sw_block"]:
        return None
    t, n = 0.0, 0
    for name, (s, k) in run.trace["kernels"].items():
        if "sw_block_kernel" in name:
            t, n = t + s, n + k
    blocks = run.shapes["sw_block"]
    if n != run.traced_calls * len(blocks) or t <= 0:
        return None
    bound_ms = run.traced_calls * sum(roofline.sw_block_bound(shape)[0] for shape, _ in blocks)
    return 100.0 * bound_ms / (t * 1e3)
