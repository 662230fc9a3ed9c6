"""The median host staging time of a cohort (the stream's
``stats["timings"]`` ``stage_s``), over the traced sweep."""
import statistics


def read(rec):
    timings = (rec.get("layers") or {}).get("timings")
    if not timings:
        return None
    return 1e3 * statistics.median(t["stage_s"] for t in timings)
