"""Device ms a diffusion step in the denoiser's forward: the busy time of
the trace's events inside the extents of the port's ``dps.denoise`` spans
(the EDM preconditioning, K2's STFT and ISTFT and the U-Net), per step."""

from portbench import spans

UNIT = "ms"


def read(rec):
    return spans.busy_ms_per_step(rec, "dps.denoise")
