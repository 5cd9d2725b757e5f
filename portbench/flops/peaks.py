"""Published peaks of one NVIDIA H100 SXM (dense, 700 W).

float32 cells are held to 165 TFLOP/s: the tensor cores' TF32 rate taken
three times (the split that keeps float32 accuracy), the fastest
float32-accurate matrix rate on the card, so no faster float32 method can
read over 100%.  bfloat16 cells are held to the dense bf16 rate.
"""

PEAK_FLOPS = {"float32": max(67e12, 495e12 / 3), "bfloat16": 989e12}
PEAK_BYTES = 3.35e12  # B/s, HBM3
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations over
    the peak of ``dtype`` and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
