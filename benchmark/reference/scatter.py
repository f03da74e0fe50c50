"""Row sums into an index, plainly: `out[index[e]] += source[e]`."""


def index_add_(out, dim, index, source):
    """`out.index_add_(dim, index, source)`; returns `out`."""
    return out.index_add_(dim, index, source)
