"""Changes a flush applied (the plane's ``stats["flushed_changes"]`` over
``stats["flushes"]``), over the traced slice."""


def read(rec):
    layers = rec.get("layers") or {}
    if not layers.get("flushes"):
        return None
    return layers["flushed_changes"] / layers["flushes"]
