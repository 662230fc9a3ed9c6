"""The per-op patch loop's seconds (``stats["patch_loop_seconds"]``) per
flush (the plane's ``stats["flushes"]``), over the traced slice."""


def read(rec):
    layers = rec.get("layers") or {}
    if not layers.get("flushes"):
        return None
    return 1e3 * layers["patch_loop_seconds"] / layers["flushes"]
