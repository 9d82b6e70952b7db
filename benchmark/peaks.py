"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit), and the ceiling a roofline share is taken against.

The port's kernels compute fp32 products as 3xTF32 (three TF32 products
each), so a product costs three at the TF32 rate: the ceiling of a call is
the larger of its bytes over the memory rate and 3 x its operations over
the TF32 rate, which keeps a sound share under 100%. `mfu` takes the same
product rate.
"""

PEAK_TF32 = 495e12  # FLOP/s, dense TF32 tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3
PRODUCTS_PER_FP32 = 3  # 3xTF32
PEAK_FP32_PRODUCTS = PEAK_TF32 / PRODUCTS_PER_FP32  # fp32 FLOP/s through 3xTF32


def ceiling_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32_PRODUCTS)
