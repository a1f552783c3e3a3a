"""Device launches (kernels, copies, sets) a diffusion step: the host's
enqueue work, which paces the step where the device waits for it."""

UNIT = "launches"


def read(rec):
    return len(rec["events"]) / rec["steps"] if rec["events"] and rec["steps"] else None
