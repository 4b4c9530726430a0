"""The card's peaks and the least time a stencil apply could take on it.

A frozen copy of fea-tpu's ``chip_smoke.py`` arithmetic (``bound``,
``neighbour_terms``, ``stencil_bound``, ``var_bytes``): the work the
apply needs, whatever implements it. Bytes: the state read once, the
output written once, the free mask read once (the masked form), and the
weights once; operations: 2 x 9 for each (node, neighbour) pair inside
the grid. The least time is the larger of the bytes over the memory rate
and the operations over the peak rate of their type.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet,
dense): 3.35 TB/s of HBM3; 67 TFLOP/s float32 and 34 TFLOP/s float64
outside the tensor cores.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ESIZE = {"float32": 4, "float64": 8}
REGION_TABLE_VALUES = 27 * 27 * 9  # the voxel stencil's (27 regions, 27 offsets, 3, 3) table


def node_grid(cells) -> tuple[int, int, int]:
    """(Z, Y, X) nodes of a grid of (nx, ny, nz) cells."""
    nx, ny, nz = cells
    return nz + 1, ny + 1, nx + 1


def neighbour_terms(Z: int, Y: int, X: int) -> int:
    """(node, offset) pairs with the neighbour inside the grid: each axis
    of n points has 3n - 2 of them."""
    return (3 * Z - 2) * (3 * Y - 2) * (3 * X - 2)


def bound_s(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    """(least seconds, what sets them)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _state_bytes(Z: int, Y: int, X: int, masked: bool) -> int:
    return (3 if masked else 2) * 3 * Z * Y * X


def voxel_apply(cells, dtype: str, masked: bool) -> tuple[float, str]:
    """One voxel stencil apply (K1 f32, K2 f64): one region table."""
    Z, Y, X = node_grid(cells)
    nbytes = (_state_bytes(Z, Y, X, masked) + REGION_TABLE_VALUES) * ESIZE[dtype]
    return bound_s(nbytes, 2 * 9 * neighbour_terms(Z, Y, X), dtype)


def var_apply(cells, dtype: str, masked: bool) -> tuple[float, str]:
    """One variable-weight stencil apply (K4 f32, K5 f64) on a field whose
    blocks are symmetric: 9 weights for each unordered pair of
    neighbouring nodes and for each node's centre, the other blocks being
    their transposes."""
    Z, Y, X = node_grid(cells)
    n = Z * Y * X
    nbytes = (9 * (neighbour_terms(Z, Y, X) + n) // 2 + _state_bytes(Z, Y, X, masked)) * ESIZE[dtype]
    return bound_s(nbytes, 2 * 9 * neighbour_terms(Z, Y, X), dtype)


def share(trace, kernel: str, bound: float) -> float | None:
    """Percent of ``bound`` seconds in the mean time of the launches of
    the device kernel whose name holds ``kernel`` over the finest grid:
    those with the most thread blocks (a coarser level of a hierarchy,
    run by the same kernel, launches fewer). None where there are none,
    or where the trace gives no launch its blocks."""
    launches = [(us, blocks) for name, us, blocks in trace.kernels if kernel in name]
    if not launches or any(b is None for _, b in launches):
        return None
    most = max(b for _, b in launches)
    times = [us for us, b in launches if b == most]
    return 100.0 * bound / (sum(times) * 1e-6 / len(times))
