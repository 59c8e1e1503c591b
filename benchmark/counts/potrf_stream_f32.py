"""potrf_stream_f32 on an n×n float32 matrix in place: the operations of
a Cholesky factorization, and the bytes of the lower triangle read once
and of the whole matrix written once (the factor and the zeroed strict
upper)."""

from benchmark.counts import potrf


def ops(n):
    return potrf.flops(n)


def nbytes(n):
    return 4 * (n * (n + 1) // 2 + n * n)
