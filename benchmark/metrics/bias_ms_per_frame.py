"""Device milliseconds a restored frame of the port's conv-bias kernels
(ops/bias_add.py: the bias alone, and the bias with a residual, found by
their exact names in the trace) over the traced calls' frames.  Nothing
where neither ran."""

KERNELS = ("bias_add_kernel", "bias_residual_add_kernel")


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = sum(run.trace["kernels"].get(name, (0.0, 0))[0] for name in KERNELS)
    return s * 1e3 / run.traced_frames if s > 0 else None
