"""Milliseconds a decode call spends in its step loop (spans ssnt.steps
and ssnt.step: the fused steps and the loop's own appends), split as
encoder.ms is (perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.layer_ms(run, "steps")
