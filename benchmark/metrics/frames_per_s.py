"""Restored frames delivered to host memory in the window, per second of
the window (host clock); padding outputs do not count."""


def read(run):
    return sum(rec["call"].n_valid for rec in run.records) / run.seconds
