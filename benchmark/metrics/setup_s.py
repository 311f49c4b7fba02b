"""setup_s (end to end): the seconds from the process's start to the
window's start: imports, the CUDA context, the inputs made from the seed,
the kernels loaded (built, in a checkout's first run) and the warm-up."""


def read(win) -> float:
    return win.setup_s
