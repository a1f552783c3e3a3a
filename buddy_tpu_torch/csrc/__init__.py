"""Kernel sources of the port.

* ``groupnorm.cu`` (K1), ``stft.cu`` (K2), ``subband_conv.cu`` (K3),
  ``spec_loss.cu`` (K4's loss pair), ``minphase.cu`` (K5),
  ``filter_design.cu`` (K6), ``wpe_solve.cu`` (K7) and ``qconv.cu`` (K10,
  the int8 convolution and its quantization): CUDA C++ for sm_90a
  with a plain C interface, compiled by ``ops/_build.py`` at first use;
  ``fft.cuh`` holds the shared-memory FFT stages that K2, K3 and K5 share.
* ``spec_loss.py`` (K4's compression and its vjp): Triton, JIT-compiled at
  its first launch.  It imports ``triton`` at the top, so only the
  launching functions in ``ops/`` import it.
"""
