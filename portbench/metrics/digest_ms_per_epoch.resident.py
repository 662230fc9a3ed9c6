"""The median, over the traced epochs, of an epoch's ``mesh.digest`` spans
summed (two an epoch, after the rounds and after the all-to-all): every
replica's digest on its card, the cross-card sum and the readback."""
import statistics


def read(rec):
    spans = (rec.get("layers") or {}).get("digest_s")
    if not spans:
        return None
    return 1e3 * statistics.median(spans)
