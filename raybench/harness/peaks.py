"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's full 700 W power limit): float32 outside the tensor
cores, and HBM3 bandwidth.  A roofline share is stated against these,
with the card's power limit beside it."""

H100 = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def bound_s(ops: float, nbytes: float, peak: dict = H100):
    """(least seconds, which bound binds) of work of `ops` operations and
    `nbytes` bytes."""
    t_ops, t_bytes = ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
