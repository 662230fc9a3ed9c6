"""The 95th percentile, by nearest rank, of every submission due in the
window, each from when it was due to when its ``Submission`` resolved; a
failed or shed submission counts as never resolving."""
import math

from portbench.core import p95


def read(rec):
    lat = rec.get("latencies_s")
    if not lat:
        return None
    value = p95(lat)
    return None if math.isinf(value) else 1e3 * value
