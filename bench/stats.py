"""Order statistics of a run's samples."""

from __future__ import annotations

import statistics


def percentile(values, q: int) -> float:
    """The ``q``-th percentile (1..99) of ``values``, as
    ``statistics.quantiles(values, n=100)`` cuts them (its exclusive
    method)."""
    values = list(values)
    if len(values) < 2:
        raise ValueError(f"a percentile needs 2 samples or more, "
                         f"got {len(values)}")
    return statistics.quantiles(values, n=100)[q - 1]
