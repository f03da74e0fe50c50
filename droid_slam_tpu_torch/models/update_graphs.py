"""The update operator replayed from CUDA graphs, one for each edge count.

`UpdateGraphs` captures `UpdateModule.forward` (encoders, ConvGRU, heads
and GraphAgg) at every edge count E = 1..EA, GraphAgg over E segment rows
(ids below E; rows past the frame count are unused, the JAX package's
"local segments"), all graphs in one memory pool.  The graphs read the
table's input buffers and write its output buffers, rows [:E] of each;
nothing in them waits for the host.  A call reaches a replay through the
module itself (`net.update(..., graphs=table)`), so forward hooks see
every call at the shapes that run; an edge count without a graph, or
another segment count, runs eagerly.  Spans `op.capture` (once) and
`op.replay` (each call).
"""

import torch

from ..utils import graphs
from ..utils.timers import span
from .update import COR_PLANES


class UpdateGraphs:
    """CUDA graphs of `update` (an `UpdateModule`) at E = 1..EA edges of
    (h, w) maps, with or without the upsampling mask; `inp_dtype` is the
    context features' dtype.  Outputs are the table's buffers, valid
    until the next replay."""

    def __init__(self, update, EA, h, w, inp_dtype, with_upmask):
        self.update = update
        self.with_upmask = with_upmask
        dev = update.corr_encoder_0.weight.device
        dt = update.corr_encoder_0.weight.dtype

        def buf(c, dtype=torch.float32):
            return torch.zeros((EA, h, w) + c, dtype=dtype, device=dev)

        # net, inp, corr, flow, segment ids
        self.inputs = [buf((128,)), buf((128,), inp_dtype),
                       buf((COR_PLANES,)), buf((4,)),
                       torch.zeros(EA, dtype=torch.int64, device=dev)]
        # net, delta, weight, eta[, upmask]
        self.outputs = [buf((128,), dt), buf((2,)), buf((2,)), buf(())]
        if with_upmask:
            self.outputs.append(buf((8 * 8 * 9,), dt))
        self.graphs = {}

    def capture(self):
        """Capture every edge count, the largest first (the pool grows to
        its size once; the smaller ones reuse it)."""
        EA = self.inputs[0].shape[0]
        with span("op.capture"), torch.no_grad():
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream()
            for E in range(EA, 0, -1):
                self.graphs[E] = graphs.capture(lambda: self._run(E), pool,
                                                stream)[0]

    def _run(self, E):
        net, inp, corr, flow, ix = (t[:E] for t in self.inputs)
        out = self.update.forward(net, inp, corr, flow, ix=ix, nseg=E,
                                  with_upmask=self.with_upmask)
        for o, x in zip(self.outputs, out):
            o[:E].copy_(x)

    def fits(self, E, nseg, with_upmask):
        """Does a graph serve a call over E edges and nseg segments?"""
        return (nseg == E and E in self.graphs
                and with_upmask == self.with_upmask)

    def __call__(self, net, inp, corr, flow, ix):
        E = net.shape[0]
        for buf, x in zip(self.inputs, (net, inp, corr, flow, ix)):
            buf[:E].copy_(x)
        with span("op.replay"):
            self.graphs[E].replay()
        return tuple(o[:E] for o in self.outputs)
