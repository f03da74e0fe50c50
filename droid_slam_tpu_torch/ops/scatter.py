"""Sums of rows into an index: `out[index[e]] += source[e]`.

On a CUDA tensor `index_add_` adds with float atomics, whose order, and
so the rounding of every sum, changes from run to run: two runs of the
same frames then part after the boot (ROADMAP C7,
tools/torch_determinism.py).  `index_put_(accumulate=True)` sorts the
index and sums each row in the sorted order, so the card repeats bit for
bit.  On the CPU `index_add_` adds serially and repeats already.
"""


def index_add_(out, dim, index, source):
    """`out.index_add_(dim, index, source)` in a sum order that `index`
    alone fixes; returns `out`."""
    if not out.is_cuda:
        return out.index_add_(dim, index, source)
    out.movedim(dim, 0).index_put_((index,), source.movedim(dim, 0),
                                   accumulate=True)
    return out
