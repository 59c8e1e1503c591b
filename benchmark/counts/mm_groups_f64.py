"""mm_groups_f64, the d tier's Ozaki product with its f64 epilogue: the
int8 work of mm_groups_f32pair, S(S + 1)/2 int8 products of 2mnk
operations; each slice of both operands and their f64 scales read once,
the f64 result written once, and ``out`` read once more where the update
reads it (``c_read``: beta not 0)."""

from benchmark.counts import mm_groups_f32pair


def ops(slices, m, n, k):
    return mm_groups_f32pair.ops(slices, m, n, k)


def nbytes(slices, m, n, k, c_read):
    return slices * (m + n) * k + 8 * (m + n) + 8 * m * n * (1 + bool(c_read))
