"""Device ms a step (a diffusion step or a train step) in the network's
convolutions, cuDNN's engines and K8's transposed convolutions among them,
by kernel name."""

from portbench.roofline.kernels import conv_us

UNIT = "ms"


def read(rec):
    us = conv_us(rec["events"])
    return us * 1e-3 / rec["steps"] if us > 0 else None
