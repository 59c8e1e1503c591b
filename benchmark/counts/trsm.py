"""Triangular solve of an n×n factor against k right-hand sides: n²·k
operations (LAPACK's count of xTRSM, left side)."""


def flops(n, k):
    return n * n * k
