"""Device milliseconds a restored frame of the cuDNN convs (the trace's
"conv (cuDNN)" group, the upsamples' transposed convs among them)."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    s = run.trace["groups_s"].get("conv (cuDNN)", 0.0)
    return s * 1e3 / run.traced_frames if s > 0 else None
