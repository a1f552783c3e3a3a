"""The share of the window's wall time in which no operation ran on the
device."""

UNIT = "%"


def read(rec):
    if not rec["events"]:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
