"""Mean host milliseconds from the start of a clip's ``pgt.prime`` to the
end of its first call's ``pgt.first_chunk_sync``, over the window's
untraced clips (benchmark/spans.py): the start-up each clip pays."""

import spans


def read(run):
    return spans.clip_start_ms(run)
