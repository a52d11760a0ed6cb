"""``{"kind": "even"}``, the default: the ``reads`` group's ``count``
lengths spread evenly over its ``shortest``-``longest``, the midpoints of
``count`` equal steps (upstream's ``SignalGenerator``)."""

import numpy as np


def multiset(spec: dict) -> np.ndarray:
    """The lengths of ``spec`` (a ``reads`` group), in ascending order."""
    extra = set(spec.get("lengths", {})) - {"kind"}
    if extra:
        raise ValueError(f"even lengths take no {sorted(extra)}")
    reads, shortest, longest = spec["count"], spec["shortest"], spec["longest"]
    step = (longest - shortest) / reads
    return (shortest + step * (np.arange(reads) + 0.5)).astype(np.int64)
