"""``{"kind": "lognormal", "median": m, "n50": n}``, in samples: the
quantiles, at the midpoints of ``count`` equal steps, of a log-normal with
median ``m`` and sigma ``sqrt(ln(n / m))`` (so that its length-weighted
median, the N50, is ``n``), truncated to the ``reads`` group's
``shortest``-``longest``, each cut to a whole sample; the largest is set to
``longest``, so the longest read is in the set once."""

import math
import statistics

import numpy as np


def multiset(spec: dict) -> np.ndarray:
    """The lengths of ``spec`` (a ``reads`` group), in ascending order."""
    shape = spec["lengths"]
    extra = set(shape) - {"kind", "median", "n50"}
    if extra:
        raise ValueError(f"log-normal lengths take no {sorted(extra)}")
    reads, shortest, longest = spec["count"], spec["shortest"], spec["longest"]
    median = shape["median"]
    dist = statistics.NormalDist(math.log(median),
                                 math.sqrt(math.log(shape["n50"] / median)))
    lo, hi = dist.cdf(math.log(shortest)), dist.cdf(math.log(longest))
    out = np.array([math.exp(dist.inv_cdf(lo + (hi - lo) * (i + 0.5) / reads))
                    for i in range(reads)]).astype(np.int64)
    if reads:
        out[-1] = longest
    return out
