"""Device milliseconds a restored frame of the port's GroupNorm (+ SiLU)
kernel pair (ops/group_norm.py: its statistics and apply kernels, found
by their exact names in the trace) over the traced calls' frames.
Nothing where neither ran."""

KERNELS = ("group_norm_stats_kernel", "group_norm_apply_kernel")


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = sum(run.trace["kernels"].get(name, (0.0, 0))[0] for name in KERNELS)
    return s * 1e3 / run.traced_frames if s > 0 else None
