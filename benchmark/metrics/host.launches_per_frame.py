"""Device operations in the traced window per frame tracked: what the host
dispatches one at a time."""


def read(rec):
    return rec["trace"]["launches"] / len(rec["latency_ms"]) if rec["latency_ms"] else None
