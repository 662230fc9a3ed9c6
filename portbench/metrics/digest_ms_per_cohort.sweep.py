"""The median device time of a cohort's digest (the stream's
``stats["timings"]`` ``digest_ms``, CUDA events), over the traced sweep."""
import statistics


def read(rec):
    timings = (rec.get("layers") or {}).get("timings")
    if not timings or any(t.get("digest_ms") is None for t in timings):
        return None
    return statistics.median(t["digest_ms"] for t in timings)
