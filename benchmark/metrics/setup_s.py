"""Seconds from the start of the process to the first timed call: import,
the card's context, the kernel library (built in a checkout's first run),
inputs made from the seed, and every shape warmed."""


def read(run):
    return run.setup_s
