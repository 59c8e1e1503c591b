"""Cholesky factorization of an n×n matrix: n³/3 + n²/2 + n/6 operations
(LAPACK's count of xPOTRF, the reference library's benchmark count)."""


def flops(n):
    return n ** 3 / 3 + n ** 2 / 2 + n / 6
