"""Host patch assembly's seconds (``stats["patch_assemble_seconds"]``) per
flush, over the traced slice."""


def read(rec):
    layers = rec.get("layers") or {}
    if not layers.get("flushes"):
        return None
    return 1e3 * layers["patch_assemble_seconds"] / layers["flushes"]
