"""Set-up: process start until the first timed call can start (CUDA
context, library loads and builds, the pool's images, warm-up calls)."""


def read(run):
    return run.setup_s
