"""Plain right-looking blocked Cholesky: the reference of ``potrf("L", A)``.

Each diagonal block by ``torch.linalg.cholesky_ex``, the panel below it by
a triangular solve, the trailing matrix by one product in the caller's
precision (where nearly all the operations are, so the TF32 control is
TF32 where it counts).
"""

import torch

from benchmark.reference import PRECISIONS, matmul

#: the reference's block width
NB = 256


def potrf_lower(A, prec="f64", nb=NB):
    """(L, info) for the lower triangle of the symmetric A: L lower
    triangular with L·Lᵀ = A in ``prec``, info the 1-based index of the
    first pivot that is not positive (0 on success; L is then valid only
    above it). A is not modified; only its lower triangle is read."""
    n = A.shape[0]
    W = torch.tril(A.to(PRECISIONS[prec]))
    W = W + torch.tril(W, -1).T
    for k in range(0, n, nb):
        e = min(k + nb, n)
        D, info = torch.linalg.cholesky_ex(W[k:e, k:e])
        if int(info):
            return torch.tril(W), k + int(info)
        W[k:e, k:e] = D
        if e < n:
            P = torch.linalg.solve_triangular(D.T, W[e:, k:e], upper=True,
                                              left=False)
            W[e:, k:e] = P
            W[e:, e:] -= matmul(P, P.T, prec)
    return torch.tril(W), 0
