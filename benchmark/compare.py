"""The comparison that decides ``correct``: the numbers the calls compute
against the reference, and the judgement of each against its limit
(``limits/<cell>.json``)."""

import math
import statistics

import torch


def rel_err(got, ref):
    """max|got − ref| / max|ref|, in float64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def tril_rel_err(got, ref):
    """:func:`rel_err` of the lower triangles."""
    return rel_err(torch.tril(got.double()), torch.tril(ref.double()))


def worst(values):
    """The largest of ``values``, NaN where any is NaN (``max`` would drop
    it), NaN where there are none."""
    values = list(values)
    if not values or any(math.isnan(v) for v in values):
        return math.nan
    return max(values)


def leaf_gap(prog, ref, grads_ref):
    """The worst leaf's gap between the program's and the reference's norm
    of a quantity, against the reference's norm of that leaf or of the
    median leaf, whichever is larger. Leaves whose reference gradient
    lies under a thousandth of the median leaf's are left out: they move
    by rounding alone. Each leaf here is a scalar, its norm |x|."""
    med_g = statistics.median(abs(g) for g in grads_ref)
    med = statistics.median(abs(r) for r in ref)
    return worst(abs(abs(p) - abs(r)) / max(abs(r), med)
                 for p, r, g in zip(prog, ref, grads_ref)
                 if abs(g) >= 1e-3 * med_g)


def judge(numbers, limits):
    """(correct, checks): each number beside its limit, in the limits'
    order. A number without a limit, a limit without a number, and a
    number that is not finite or above its limit make the run not
    correct."""
    checks, ok = {}, set(numbers) == set(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks
