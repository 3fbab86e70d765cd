"""Process start to the first timed request: imports, the kernel
libraries' load (their build, on a checkout's first run), the weights,
the plan, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
