"""buddy_tpu_torch — BUDDy blind dereverberation in PyTorch for NVIDIA Hopper.

A port of the JAX package ``buddy_tpu`` (which stays in the repository as the
reference).  Plain tensor code is PyTorch; the hot ops that the JAX package
shaped by hand for the TPU are kernels written by hand for the H100:

* K1 GroupNorm(+SiLU), forward and backward, CUDA C++ (``ops/groupnorm.py``,
  ``csrc/groupnorm.cu``);
* K2 STFT analysis / ISTFT synthesis, CUDA C++ (``ops/stft.py``,
  ``csrc/stft.cu``, with the FFT stages of ``csrc/fft.cuh``);
* K3 subband frame convolution, its two adjoints and the frame spectrum, by
  FFTs in shared memory, CUDA C++ (``ops/subband_conv.py``,
  ``csrc/subband_conv.cu``; plans in ``ops/fft_plan.py``);
* K4 power-law compressed STFT loss, forward and backward: the loss pair in
  CUDA C++ (``ops/spec_loss.py``, ``csrc/spec_loss.cu``), the compression
  and its vjp in Triton (``csrc/spec_loss.py``);
* K5 the minimum-phase projection, its four FFTs included, one launch a
  direction (a thread-block cluster a row), CUDA C++ (``ops/minphase.py``,
  ``csrc/minphase.cu``; plan in ``ops/fft_plan.py``);
* K6 the blind operator's filter design with its phasor, forward and
  backward, CUDA C++ (``ops/filter_design.py``, ``csrc/filter_design.cu``);
* K7 the WPE normal equations, CUDA C++ (``ops/wpe_solve.py``,
  ``csrc/wpe_solve.cu``).

Each kernel wrapper runs its plain PyTorch version only for tensors on the
CPU (the parity tests); a CUDA tensor launches the kernel or raises.
Entry points (network, operators, samplers, the tester and its CLI
``python -m buddy_tpu_torch.testing``) run on the card unless the caller
passes ``device="cpu"``.

This package imports nothing from ``buddy_tpu`` and nothing of JAX.
"""
