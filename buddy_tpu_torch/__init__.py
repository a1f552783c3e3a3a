"""buddy_tpu_torch — BUDDy blind dereverberation in PyTorch for NVIDIA Hopper.

A port of the JAX package ``buddy_tpu`` (which stays in the repository as the
reference).  Plain tensor code is PyTorch; the hot ops that the JAX package
shaped by hand for the TPU are kernels written by hand for the H100:

* K1 GroupNorm(+SiLU), forward and backward, Triton (``ops/groupnorm.py``);
* K2 STFT analysis / ISTFT synthesis, CUDA C++ (``ops/stft.py``,
  ``csrc/stft.cu``);
* K3 subband frame convolution and its two adjoints, CUDA C++
  (``ops/subband_conv.py``, ``csrc/subband_conv.cu``).

Each kernel wrapper runs its plain PyTorch version only for tensors on the
CPU (the parity tests); a CUDA tensor launches the kernel or raises.
Entry points (network, operators, sampler) run on the card unless the
caller passes ``device="cpu"``.

This package imports nothing from ``buddy_tpu`` and nothing of JAX.
"""
