"""Set-up: process start to the first measured call (imports, the CUDA
context, the kernels' libraries, prepare, the warm-up), in s."""


def read(run):
    return run["setup_s"]
