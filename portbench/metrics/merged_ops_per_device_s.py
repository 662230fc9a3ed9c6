"""Internal ops delivered to every replica (counted from the changes) over
the device's busy seconds in the whole window (the union of its kernels,
copies and sets in the trace): the rate at which the card merges, all the
window's work over all of its time on the device."""


def read(rec):
    if not rec.get("device_busy_s") or "delivered_ops" not in rec:
        return None
    return rec["delivered_ops"] / rec["device_busy_s"]
