"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) at its full 700 W power limit, as chip_smoke.py states them
(lines 289-294): HBM bandwidth and the FP32 rate outside the tensor
cores. A card set below 700 W runs slower under load; the result line's
``device`` carries the card's name, and PERF.md its power limit beside
every share of these peaks."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
POWER_LIMIT_W = 700.0


def least_s(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(flop / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
