"""Seconds from the process's start to the window: imports, the scene, the
weights, the program's set-up and warm-up, and in a first run the kernels'
builds."""


def read(run):
    return run.setup_s
