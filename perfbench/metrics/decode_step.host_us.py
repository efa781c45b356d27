"""Host microseconds a step of the decode loop takes in its wrapper: the
length of a ssnt.step span (from the call of the step until its launches
are queued, for the fused route), over the traced batches' steps
(perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.step_host_us(run)
