"""Replicas whose cohort finished its merge and digest in the window, over
the whole window."""


def read(rec):
    if "swept_replicas" not in rec:
        return None
    return rec["swept_replicas"] / rec["window_s"]
