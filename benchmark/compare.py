"""The comparison that decides ``correct`` for a training cell.

Both sides report, for the first three train steps from the same
parameters over the same rows: each step's loss, each leaf's norm of the
first gradient as the solver takes it (its velocity after one step over
the learning rate: the gradient plus the weight decay), and each leaf's
norm of the parameters' change after the third step. Three numbers are
compared, each against a limit of its own (``workloads/<cell>.json``):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap of first-gradient norms;
* ``update_gap``: the worst leaf's gap of change norms;

a leaf's gap taken between the two norms (not the norm of their
difference) over the reference's norm of that leaf or of the median
leaf, whichever is larger, since some gradients are all but zero. Leaves
whose reference gradient is under a thousandth of the median leaf's move
by round-off alone and are left out of both leaf numbers.
"""

import math
import statistics

#: a leaf whose reference gradient norm is under this share of the
#: median leaf's is left out of the leaf numbers
NOUGHT_SHARE = 1e-3


def numbers(prog, ref):
    """{"loss_gap", "grad_gap", "update_gap"} of the program's readings
    ``prog`` against the reference's ``ref`` (each {"losses": [...],
    "grad_norms": [...], "update_norms": [...]}, leaves in one order)."""
    loss_gap = max(_gap(p, r, abs(r)) for p, r in zip(prog["losses"],
                                                       ref["losses"]))
    g_ref = ref["grad_norms"]
    g_median = statistics.median(g_ref)
    keep = [i for i, g in enumerate(g_ref) if g >= NOUGHT_SHARE * g_median]
    grad_gap = max(_gap(prog["grad_norms"][i], g_ref[i],
                        max(g_ref[i], g_median)) for i in keep)
    u_ref = ref["update_norms"]
    u_median = statistics.median(u_ref[i] for i in keep)
    update_gap = max(_gap(prog["update_norms"][i], u_ref[i],
                          max(u_ref[i], u_median)) for i in keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


def _gap(p, r, scale):
    if not (math.isfinite(p) and math.isfinite(r)) or scale <= 0:
        return math.inf
    return abs(p - r) / scale


def verdict(nums, limits):
    """{name: {"value", "limit", "ok"}}: each number within its limit (a
    missing limit fails)."""
    out = {}
    for name, value in nums.items():
        limit = limits.get(name)
        ok = limit is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value,
                     "limit": math.nan if limit is None else limit,
                     "ok": ok}
    return out
