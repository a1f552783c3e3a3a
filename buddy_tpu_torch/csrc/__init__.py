"""Kernel sources of the port.

* ``groupnorm.cu`` (K1), ``stft.cu`` (K2), ``subband_conv.cu`` (K3),
  ``filter_design.cu`` (K6) and ``wpe_solve.cu`` (K7): CUDA C++ for sm_90a
  with a plain C interface, compiled by ``ops/_build.py`` at first use;
  ``fft.cuh`` holds the shared-memory FFT stages that K2 and K3 share.
* ``spec_loss.py`` (K4) and ``minphase.py`` (K5): Triton, JIT-compiled at
  their first launch.  They import ``triton`` at the
  top, so only the launching functions in ``ops/`` import them.
"""
