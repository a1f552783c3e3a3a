"""Host ms a diffusion step in the port's ``dps.step`` spans outside the
``noise.draw`` spans they hold: the host's time to enqueue a step's work,
with its waits for a full launch queue, the draws' host work and blocking
uploads left out."""

from portbench import spans

UNIT = "ms"


def read(rec):
    sp = spans.aligned(rec)
    steps = {s["id"] for s in sp or () if s["name"] == "dps.step"}
    if not steps:
        return None
    draws = [s for s in sp if s["name"] == "noise.draw" and s["parent"] in steps]
    return (spans.host_ms(sp, "dps.step") - spans.host_ms(draws, "noise.draw")) / rec["steps"]
