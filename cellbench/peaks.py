"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity), at its full 700 W power limit: the yardstick of every
roofline share and MFU here. A copy of ``cluster/topology.py``'s, kept
with the benchmark."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12    # HBM3, bytes/s


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth."""
    return max(flops / BF16_FLOPS, bytes_ / HBM_BYTES_PER_S)
