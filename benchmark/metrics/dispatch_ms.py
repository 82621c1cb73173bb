"""Mean host milliseconds of the entry call (which returns before the
device finishes), over the calls of the traced run's window that the
profiler did not record."""


def read(run):
    t = [(rec["t_dispatched"] - rec["t_submit"]) * 1e3
         for rec in run.untraced_records if rec.get("in_window")]
    return sum(t) / len(t) if t else None
