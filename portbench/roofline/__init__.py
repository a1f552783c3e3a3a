"""The yardstick's arithmetic: the H100's peaks, each kernel's bytes and
operations as functions of its shapes, the classifiers that name the
profiler's kernels, and the model's operation count.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): 3.35 TB/s of HBM3, 989 TFLOP/s in bfloat16, 67 TFLOP/s in float32
outside the tensor cores (the port runs float32 with TF32 off).
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(n_bytes: float, n_flops: float = 0.0, peak_flops: float = PEAK_FLOPS["float32"]):
    """The least time for the work: bytes at the memory's rate or
    operations at the peak, whichever is longer, in seconds."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / peak_flops)
