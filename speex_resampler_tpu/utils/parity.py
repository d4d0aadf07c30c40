"""The output-parity bound shared by the tests and the on-device smoke run.

The float universe regroups the reference's f32 accumulation, so an
output may land one LSB off when its pre-rounding sum sits on a WORD2INT
rounding boundary.  The contract is max |err| <= 1 LSB with few such ties;
the fixed universe and the order-faithful host loops are exact.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lsb_tie_limit", "lsb_diff"]


def lsb_tie_limit(n: int, max_mismatch_rate: float = 5e-3) -> float:
    """The Poisson-aware tie-count bound (mean + 4 sigma + 2) for ``n``
    compared samples: one definition for every check, so verdicts can
    never disagree on the same draw."""
    lam = max_mismatch_rate * n
    return lam + 4.0 * float(np.sqrt(lam * (1.0 - max_mismatch_rate))) + 2.0


def lsb_diff(ours: np.ndarray, golden: np.ndarray) -> tuple[int, int, int]:
    """(max |err| in LSB, samples that differ, samples compared) of two
    same-shaped int16 arrays."""
    if ours.shape != golden.shape:
        raise ValueError(f"shape mismatch {ours.shape} vs {golden.shape}")
    d = np.abs(np.asarray(ours, np.int32) - np.asarray(golden, np.int32))
    if d.size == 0:
        return 0, 0, 0
    return int(d.max()), int((d > 0).sum()), int(d.size)
