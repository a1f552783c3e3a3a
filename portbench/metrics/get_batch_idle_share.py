"""The device's idle time put down to the port's ``train.get_batch`` span by
the gap rule (``portbench/spans.py``), over the window's wall time, in %."""

from portbench import spans

UNIT = "%"


def read(rec):
    return spans.idle_share(rec, "train.get_batch")
