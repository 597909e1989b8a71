"""The share of the traced sequence in which no operation ran on the card:
1 - (union of device intervals) / (traced window), in percent."""


def read(r):
    t = r.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
