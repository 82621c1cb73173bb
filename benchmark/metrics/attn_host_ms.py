"""Mean host milliseconds a call of the program's ``pgt.attn`` span, over
the untraced calls of the window (benchmark/spans.py).  Beside
``attn_dev_ms_per_frame``: a stage whose host time exceeds its device
interval is paced by the host."""

import spans


def read(run):
    return spans.host_ms(run, "pgt.attn")
