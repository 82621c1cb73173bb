"""The 95th percentile (nearest rank), over every call completed in the
window, of the time from handing its frames to the entry call until its
uint8 output is in host memory (host clock, ms)."""

import math


def read(run):
    lat = sorted((rec["t_done"] - rec["t_submit"]) * 1e3 for rec in run.records)
    if len(lat) < 20:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
