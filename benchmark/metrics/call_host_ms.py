"""Mean host milliseconds of the program's ``pgt.call`` span, over the
untraced calls of the window (benchmark/spans.py): the entry call's
dispatch measured inside the program (for the faces, without the
upload and normalization made before the forward)."""

import spans


def read(run):
    return spans.host_ms(run, "pgt.call")
