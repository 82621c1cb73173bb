"""Kernel K6 (dense_mha_kernel, the code transformer's attention core)
against its roofline, %: roofline.mha_bound of each attention call the
reference makes, at its shape, over the kernel's device time in the
trace.  Nothing where it did not run once per reference call."""

import roofline


def read(run):
    if run.trace is None or not run.shapes or not run.shapes["mha"]:
        return None
    t, n = 0.0, 0
    for name, (s, k) in run.trace["kernels"].items():
        if "dense_mha_kernel" in name:
            t, n = t + s, n + k
    calls = run.shapes["mha"]
    if n != run.traced_calls * len(calls) or t <= 0:
        return None
    bound_ms = run.traced_calls * sum(roofline.mha_bound(*shape)[0] for shape in calls)
    return 100.0 * bound_ms / (t * 1e3)
