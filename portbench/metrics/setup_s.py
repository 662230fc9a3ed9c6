"""Seconds from the start of the process to the start of the window."""


def read(rec):
    return rec["setup_s"]
