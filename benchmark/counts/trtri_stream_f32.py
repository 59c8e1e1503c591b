"""trtri_stream_f32 on an n×n lower-triangular float32 matrix, out of
place: n³/3 + 2n/3 operations (LAPACK's count of xTRTRI), the lower
triangle read once and the whole n×n result written once (the inverse
and its zero strict upper)."""


def ops(n):
    return n ** 3 / 3 + 2 * n / 3


def nbytes(n):
    return 4 * (n * (n + 1) // 2 + n * n)
