"""Device microseconds a step of the fused v2 step: the device
time that the calls of `fused_class_beam_step` launched, over the
number of calls, in the traced segment."""

from perfbench import trace


def read(run):
    return trace.step_device_us(run, "v2_step")
