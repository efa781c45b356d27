"""Device operations (kernels, copies, memsets, as the profiler's CUPTI
records them) that a decode call launched inside its root span, over the
traced batches' decode calls: the launches a batch
(perfbench/program_spans)."""

from perfbench import program_spans


def read(run):
    return program_spans.device_ops_per_call(run)
