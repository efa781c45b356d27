"""Device microseconds a frame of the fused v1 step: the device
time that the calls of `fused_v1_beam_step` launched, over the
number of calls, in the traced segment."""

from perfbench import trace


def read(run):
    return trace.step_device_us(run, "v1_step")
