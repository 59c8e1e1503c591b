"""The benchmark's operation count of every call completed in the window
over the window's seconds (host clock), in GFLOP/s."""


def read(run):
    return run.window.flops / run.window.seconds / 1e9
