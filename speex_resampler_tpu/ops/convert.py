"""Sample-format conversion with exact reference rounding semantics.

The float build of the reference keeps internal samples as float32 **on the
±32768 int16 scale** (not normalized): s16 input is copied verbatim into the
float filter memory (resample.c:1000-1006) and converted back with WORD2INT
(arch.h:208-209) on output (resample.c:1018-1023).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["s16_to_internal", "word2int", "word2int_np"]


def s16_to_internal(x, dtype=jnp.float32):
    """s16 → internal float scale (identity scaling, resample.c:1005)."""
    return x.astype(dtype)


def word2int(x):
    """WORD2INT (arch.h:208-209):
        x < -32767.5 → -32768 ; x > 32766.5 → 32767 ;
        else int16(floor(0.5 + x)).
    ``floor(0.5 + x)`` is round-half-up, NOT round-to-nearest-even; it must
    be spelled out (jnp.round would tie-to-even).  Computed in x's dtype
    (f32 on device; callers may pass f64 for the tightest match to the C
    double-promoted floor).
    """
    y = jnp.floor(x.dtype.type(0.5) + x)
    y = jnp.where(x < x.dtype.type(-32767.5), x.dtype.type(-32768.0), y)
    y = jnp.where(x > x.dtype.type(32766.5), x.dtype.type(32767.0), y)
    return y.astype(jnp.int16)


def word2int_np(x: np.ndarray) -> np.ndarray:
    """NumPy twin of ``word2int`` for the HOST hot loops (ops/fir_exact):
    the jnp version dispatches to the default device, which would turn
    every host-path chunk into a device round-trip.  Semantics identical:
    floor(0.5+x) in x's dtype with the -32767.5/32766.5 clamp thresholds
    (arch.h:208-209)."""
    x = np.asarray(x)
    y = np.floor(x.dtype.type(0.5) + x)
    y = np.where(x < x.dtype.type(-32767.5), x.dtype.type(-32768.0), y)
    y = np.where(x > x.dtype.type(32766.5), x.dtype.type(32767.0), y)
    return y.astype(np.int16)
