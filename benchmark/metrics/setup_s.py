"""Seconds from the process's start to the window's: imports, CUDA, the model files from
the seed, the program's load and lowering, each pipeline's first frames and captures, and
the warm-up traffic."""


def read(ctx):
    return ctx["setup_s"]
