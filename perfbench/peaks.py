"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): float32 outside the tensor cores (the port keeps TF32 off)
and HBM3 bandwidth."""

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound_s(flops, nbytes):
    """The least seconds the card could take: the larger of the flops at
    the float32 peak and the bytes at the HBM rate."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)
