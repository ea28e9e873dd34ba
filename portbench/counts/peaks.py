"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): float32 outside the tensor cores,
and HBM3 bandwidth."""
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it: the
    larger of bytes over the bandwidth and operations over the float32
    rate."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
