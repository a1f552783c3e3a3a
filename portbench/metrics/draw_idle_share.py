"""The device's idle time put down to the port's ``noise.draw`` spans by the
gap rule (``portbench/spans.py``), over the window's wall time, in %."""

from portbench import spans

UNIT = "%"


def read(rec):
    return spans.idle_share(rec, "noise.draw")
