"""Kernel sources of the port.

* ``stft.cu`` (K2) and ``subband_conv.cu`` (K3): CUDA C++ for sm_90a with a
  plain C interface, compiled by ``ops/_build.py`` at first use.
* ``groupnorm.py`` (K1): Triton, JIT-compiled at its first launch.  It
  imports ``triton`` at the top, so only the launching function in
  ``ops/groupnorm.py`` imports it.
"""
