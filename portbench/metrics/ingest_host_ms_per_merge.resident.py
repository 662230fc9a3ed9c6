"""Host control plane (gate, encode, upload, commit: ``stats["host_seconds"]``)
per merge launched (``stats["launches"]``), over the epochs outside the
traced slice."""


def read(rec):
    layers = rec.get("layers") or {}
    if not layers.get("launches"):
        return None
    return 1e3 * layers["host_seconds"] / layers["launches"]
