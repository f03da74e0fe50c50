"""CUDA graph capture with the warm-up it needs."""

import torch


def capture(fn, pool=None, stream=None):
    """Run `fn()` once (library handles, workspaces and convolution plans
    are made there, outside the graph), then capture it into a CUDA graph
    on the side stream `stream` (a new one by default), in the memory
    pool `pool` where one is given.  Graphs that share a pool are
    captured on one stream, so that each capture reuses the memory the
    one before it freed.  Returns (graph, what the captured call
    returned).

    `torch.cuda.graph` would synchronize and empty the allocator's caches
    before each capture; a table of many graphs captured in a row, and
    the frames after it, would pay for that again and again."""
    fn()
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool)
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph, out
