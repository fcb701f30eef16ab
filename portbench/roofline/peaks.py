"""The NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, at its full
700 W power limit): HBM3 bandwidth and float32 outside the tensor cores.
A share of a peak is stated against these, with the card's own power limit
printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(moved_bytes: float, ops: float) -> tuple[float, str]:
    """The least time a kernel could take, and what bounds it."""
    by_bytes, by_ops = moved_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "ops"
