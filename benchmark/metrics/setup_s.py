"""setup_s: from the start of the process to the first request of the
window: imports, inputs from the seed, the program's builders, its kernels
loaded (or built, in a checkout's first run) and every shape warmed up."""


def read(run):
    return run.setup_s
