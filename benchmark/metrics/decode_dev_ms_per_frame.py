"""Device interval of the program's ``pgt.decode`` span (CUDA events at its
ends: from the device reaching the stage to its finishing the stage's last
operation, waits for the host inside it included), summed over the traced
calls, milliseconds a traced frame (benchmark/spans.py)."""

import spans


def read(run):
    return spans.device_ms_per_frame(run, "pgt.decode")
