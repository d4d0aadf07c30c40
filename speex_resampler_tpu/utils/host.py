"""Host transfer helper.

Makes readiness explicit before handing a dispatched result to NumPy, so
a device error surfaces at one call the engines' degradation guards wrap.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_host"]


def to_host(x) -> np.ndarray:
    """Block until ``x`` is ready, then view it as a NumPy array."""
    if hasattr(x, "block_until_ready"):
        x = x.block_until_ready()
    return np.asarray(x)
