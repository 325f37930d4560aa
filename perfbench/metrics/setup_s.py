"""setup_s (s): set-up on the host clock: building the program's state from
the seed, loading its kernels and warming every shape the window uses."""


def read(run):
    return run.setup_s
