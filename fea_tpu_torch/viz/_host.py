"""NumPy on the host from an array or a tensor."""
from __future__ import annotations

import numpy as np


def host(a, dtype=None) -> np.ndarray:
    """``np.asarray(a, dtype)``; a tensor (on any device) is detached and
    copied to the host first."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)
