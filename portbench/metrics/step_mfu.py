"""The model's operations a step times the window's steps, over the
window's wall time, against the peak of the configuration's precision."""

UNIT = "%"


def read(rec):
    flops = rec.get("flops_per_step")
    if not flops or not rec["events"]:
        return None
    return 100.0 * flops * rec["steps"] / rec["window_s"] / rec["peak_flops"]
