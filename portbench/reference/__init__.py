"""The plain reference of the benchmark: float32 PyTorch with TF32 off.

It imports neither ``jax`` nor ``buddy_tpu`` nor anything of
``buddy_tpu_torch``. It is written from the published algorithms (NCSN++
of score_sde, BUDDy's blind subband operator and DPS sampler, EDM
training), with the parameter names of the port's network so that one
seed-made state dict loads into both. Every constant it needs (windows,
interpolation matrices, schedules) it works out again itself.
"""

import torch


def strict_float32() -> None:
    """Full float32 for matmuls and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
