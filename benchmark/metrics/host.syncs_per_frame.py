"""Host waits for the stream (the program's sync sites: `.item()`,
`.cpu()`, `torch.nonzero`, boolean indexing, `torch.unique`,
`torch.bincount`, blocking host-to-device copies) in the traced window per
frame tracked."""

from benchmark.lib.program_trace import sync_count


def read(rec):
    n, frames = sync_count(), len(rec["latency_ms"])
    return n / frames if n and frames else None
