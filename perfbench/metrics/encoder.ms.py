"""Milliseconds a decode call spends in the encoder (span ssnt.encode):
the device-busy instants whose operations the span launched and the
device-idle instants while it is the innermost program span open on the
host, over the traced batches' decode calls (perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.layer_ms(run, "encoder")
