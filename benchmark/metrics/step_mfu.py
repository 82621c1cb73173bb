"""The whole step's share of the card's bf16 peak, %: the operations a
frame (counted once from the reference's shapes, roofline.count_flops on
the meta device) times the frames the traced window delivered, over the
window's seconds and roofline.H100_BF16_FLOPS."""

import roofline


def read(run):
    if run.trace is None or not run.flops_per_call or not run.traced_frames:
        return None
    per_frame = run.flops_per_call / run.frames_per_call
    rate = per_frame * run.traced_frames / run.trace["window_s"]
    return 100.0 * rate / roofline.H100_BF16_FLOPS
