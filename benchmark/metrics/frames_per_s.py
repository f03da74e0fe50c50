"""Frames that Droid.track took in the window over the window (host clock;
every frame ends in a synchronize)."""


def read(rec):
    return len(rec["latency_ms"]) / rec["window_s"]
