"""Internal ops delivered to every replica (counted from the changes) per
second of the host's clock, over the window's epochs outside the profiled
slice: the rate a sync server sees, paced by the host."""


def read(rec):
    layers = rec.get("layers") or {}
    if not layers.get("plain_s"):
        return None
    return layers["plain_ops"] / layers["plain_s"]
