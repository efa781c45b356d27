"""The fused v2 step's share of its roofline: the least time the card
could take for one step (perfbench/counts) over the device time a step
took, in percent."""

from perfbench import trace

COUNTS = ("v2_step_flops", "v2_step_bytes")


def read(run):
    return trace.roofline_share(run, "v2_step", "v2")
