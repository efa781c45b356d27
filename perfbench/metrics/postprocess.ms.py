"""Milliseconds a decode call spends in its post-processing (span
ssnt.postprocess with ssnt.backtrace, ssnt.mel_gather and ssnt.upsample
inside it: the stacks of the steps' outputs, the backtrace, the best
path's mel frames or the upsampling), split as encoder.ms is
(perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.layer_ms(run, "postprocess")
