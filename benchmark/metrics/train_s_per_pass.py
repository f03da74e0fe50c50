"""The window over the accumulate passes the trainer completed in it
(restarts are passes; draws, graphs and optimizer steps count in the
time)."""


def read(rec):
    return rec["window_s"] / rec["passes"] if rec["passes"] else None
