"""Host-side visualization of solutions, from NumPy arrays or tensors.

  * :mod:`fea_tpu_torch.viz.mpl`: matplotlib 3D/2D (nodes, hex faces,
    force quivers, truss and beam plots); matplotlib is imported inside
    its functions, so ``import fea_tpu_torch`` does not need it.
  * :mod:`fea_tpu_torch.viz.pv`: pyvista/VTK rendering, present only
    where pyvista imports (``HAS_PYVISTA``).

Counterpart of ``fea_tpu/viz/``.
"""
from . import mpl  # noqa: F401

try:  # optional: pyvista is not a dependency
    from . import pv  # noqa: F401

    HAS_PYVISTA = True
except ImportError:  # pragma: no cover
    HAS_PYVISTA = False

__all__ = ["mpl", "HAS_PYVISTA"]
