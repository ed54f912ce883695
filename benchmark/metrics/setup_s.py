"""Seconds from the start of the process to the first timed row or call:
imports, the CUDA context, the kernels built or loaded, the data, the
warm-up at the cell's shapes."""


def read(f):
    return f["setup_s"]
