"""Host ms a step (a diffusion step or a train step) in the port's
``noise.draw`` spans: each draw made on the host and its blocking upload.
None unless the spans count the draws ``NoiseSource.draws`` counted."""

from portbench import spans

UNIT = "ms"


def read(rec):
    sp = spans.aligned(rec)
    if sp is None or sum(s["name"] == "noise.draw" for s in sp) != rec.get("draws"):
        return None
    return spans.host_ms_per_step(rec, "noise.draw")
