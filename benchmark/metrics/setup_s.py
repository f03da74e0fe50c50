"""Set-up seconds: from the start of the run to the window's opening
(rendering the traffic, loading, kernel builds, warm-up and the set-up
frames or steps)."""


def read(rec):
    return rec["setup_s"]
