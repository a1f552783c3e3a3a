"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no CUDA they raise instead of carrying on quietly on the CPU.
Under ``torchrun`` each rank runs on its own card (``parallel/mesh.py``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA card (the first, or the rank's card
    that ``parallel.init_distributed`` set); a CPU run must be asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "buddy_tpu_torch runs on a CUDA device; no CUDA device is "
                "available (pass device='cpu' to run the plain versions)")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        set_float32_precision()
    return device


def set_float32_precision() -> None:
    """Full float32 for every float32 matmul and convolution (TF32 OFF).

    cuDNN would run float32 convolutions in TF32 by default, which keeps
    about three decimal digits; the port's float32 paths (STFT-domain
    losses, the output layer, the parity checks) are held to the JAX
    reference at float32 tolerances, so both switches are set to False.
    The U-Net body runs in bfloat16 where it is asked to, independently of
    these switches.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
