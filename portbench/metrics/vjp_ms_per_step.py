"""Device ms a diffusion step in the guidance's pull-back through the
denoiser: the busy time of the trace's events inside the extents of the
port's ``dps.vjp`` spans (absent under identity guidance), per step."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.busy_ms_per_step(rec, "dps.vjp")
