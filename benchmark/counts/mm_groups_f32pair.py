"""mm_groups_f32pair, the d tier's Ozaki product: As (S, m, k) and Bs
(S, n, k) int8 slices, every pair (s, t) with s + t < S multiplied, so
S(S + 1)/2 int8 products of 2mnk operations; each slice of both operands
read once, the f32 pair (hi, lo) written once."""


def ops(slices, m, n, k):
    return slices * (slices + 1) // 2 * 2 * m * n * k


def nbytes(slices, m, n, k):
    return slices * (m + n) * k + 8 * m * n
