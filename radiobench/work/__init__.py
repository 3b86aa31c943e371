"""The work a kernel's function needs, counted from its shapes (each
input byte read once, each output byte written once, the operations of
the plain formula), and the H100's published peaks."""

# H100 SXM, NVIDIA's data sheet: HBM bytes/s and float32 FLOP/s outside
# the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: bytes at the memory rate or
    operations at the float32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_F32)
