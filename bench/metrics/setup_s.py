"""setup_s: from the process's start to the window's start: imports, the
CUDA context, the kernel build or load, weights, engine and warm-up."""


def read(run):
    return run.setup_s
