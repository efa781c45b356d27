"""Milliseconds a decode call spends in the hoisted paths (spans
ssnt.weights and ssnt.paths: the fused weights' packing and the enc-side
projections), split as encoder.ms is (perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.layer_ms(run, "hoisted")
