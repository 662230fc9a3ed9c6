"""How far the cards' busy time overlapped in the traced slice: their busy
device-seconds summed over their union (``busy_s`` / ``busy_any_s``), 1
when the cards ran one after another, up to the cell's number of cards
when all ran at once."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("busy_any_s"):
        return None
    return prof["busy_s"] / prof["busy_any_s"]
