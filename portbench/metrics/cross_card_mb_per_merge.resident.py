"""Megabytes moved from one mesh entry to another (the port's
``mesh.p2p_bytes``) per merge of the fleet (``stats["launches"]``), over
the traced epochs."""


def read(rec):
    layers = rec.get("layers") or {}
    if layers.get("p2p_bytes") is None or not layers.get("traced_merges"):
        return None
    return layers["p2p_bytes"] / 1e6 / layers["traced_merges"]
