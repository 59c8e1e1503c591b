"""Inverse from the Cholesky factor (a triangular inverse, n³/3 + 2n/3,
then the triangular square, n³/3 + n²/2 + n/6): 2n³/3 + n²/2 + 5n/6
operations (LAPACK's counts of xTRTRI and xLAUUM)."""


def flops(n):
    return 2 * n ** 3 / 3 + n ** 2 / 2 + 5 * n / 6
