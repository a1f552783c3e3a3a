"""Host ms a train step in the port's ``train.get_batch`` span: the loader's
hand-over and the batch's blocking upload, which waits for the queue of
the previous step to drain."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.host_ms_per_step(rec, "train.get_batch")
