"""Device milliseconds a restored frame of the ATen glue around the
kernels: the trace's "elementwise/other" and "copy/layout" kernel groups
(devtrace.GROUPS) over the traced calls' frames."""


def read(run):
    if run.trace is None or not run.traced_frames:
        return None
    g = run.trace["groups_s"]
    s = g.get("elementwise/other", 0.0) + g.get("copy/layout", 0.0)
    return s * 1e3 / run.traced_frames if s > 0 else None
