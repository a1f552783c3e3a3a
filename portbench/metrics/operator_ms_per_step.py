"""Device ms a diffusion step in the blind operator's own kernels: K3
(subband filtering), K4 (compressed loss), K5 (minimum phase), K6 (filter
design), by kernel name. The operator's elementwise ops and its STFTs (K2,
shared with the denoiser) are not in it."""

from portbench.roofline.kernels import OPERATOR, named_us

UNIT = "ms"


def read(rec):
    us = named_us(rec["events"], OPERATOR)
    return us * 1e-3 / rec["steps"] if us > 0 else None
