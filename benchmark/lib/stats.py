"""Order statistics of a list of samples."""

import statistics


def percentile(values, p):
    """The p-th percentile (0 < p < 100) by linear interpolation between
    order statistics (Python's `statistics.quantiles`, inclusive)."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]

