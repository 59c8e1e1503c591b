"""gemm_f32, D = alpha·A·B + beta·C with A m×k and B k×n, float32: 2mnk
operations, A and B read once, D written once, and C read once where the
launch reads it (beta ≠ 0)."""


def ops(m, n, k):
    return 2 * m * n * k


def nbytes(m, n, k, c_read):
    return 4 * (m * k + k * n + m * n * (1 + bool(c_read)))
