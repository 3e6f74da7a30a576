"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W power limit): HBM3 at 3.35 TB/s; 67 TFLOP/s fp32 outside the tensor
cores; 989 TFLOP/s bf16 in them.  An exp or any other special function
counts as one fp32 operation: no lane count that the data sheet does not
publish."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"fp32": 67e12, "bf16": 989e12}


def bound_s(ops: float, nbytes: float, dtype: str = "fp32") -> float:
    """The least time the card could take: the larger of the operations at
    the peak of their type and the bytes at the memory rate."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
