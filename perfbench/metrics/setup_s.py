"""Seconds from the start of the process to the first timed batch:
imports, the kernels' build where one is due, the model and its weights,
and the warm-up batch."""


def read(run):
    return run["setup_s"]
