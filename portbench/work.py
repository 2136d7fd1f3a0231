"""Operations and bytes of the kernels' stages, and the least time the chip
needs for them (the roofline's bound).

Frozen from `chip_smoke.py` (`work()` / `valid_work()` and their
constants): ICP counts 8 float32 operations per (valid source, valid
target) pair of each association sweep plus 120 per valid source and
Gauss-Newton iteration (point-to-plane); the depth cost 9 per (valid point,
valid target) pair. Inputs are counted read once and outputs written once.
The counts are taken from the plain reference's run over the same frames
(its own iterations and valid pairs), so they do not depend on what
implements the stage.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W limit).
FP32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
ICP_PAIR_OPS = 8          # expanded-form distance per source x target
ICP_POINT_OPS = 120       # point-to-plane terms per source and iteration
COST_PAIR_OPS = 9         # 3 sub, 3 mul, 3 add per point x target


def least_seconds(ops: float, nbytes: float) -> float:
    """The larger of the compute bound and the memory bound."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def icp_ops(work) -> float:
    return (work.icp_pair_sweeps * ICP_PAIR_OPS
            + work.icp_point_iters * ICP_POINT_OPS)


def cost_ops(work) -> float:
    return work.cost_pairs * COST_PAIR_OPS


def icp_seconds(work) -> float:
    return least_seconds(icp_ops(work), work.icp_bytes)


def cost_seconds(work) -> float:
    return least_seconds(cost_ops(work), work.cost_bytes)
