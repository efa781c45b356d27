"""The fused v1 step's share of its roofline: the least time the card
could take for one frame (perfbench/counts) over the device time a frame
took, in percent."""

from perfbench import trace

COUNTS = ("v1_step_flops", "v1_step_bytes")


def read(run):
    return trace.roofline_share(run, "v1_step", "v1")
