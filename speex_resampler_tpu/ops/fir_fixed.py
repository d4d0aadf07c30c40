"""FIXED_POINT-build hot loops, bit-exact (host NumPy reference).

Reproduces the reference's Q15 integer hot loops
(``resampler_basic_direct_single`` / ``resampler_basic_interpolate_single``,
resample.c:331-384 / :438-496, FIXED_POINT branches; there are no _double
variants in the fixed build, resample.c:679-699) against the closed-form
phase/index math of ops/phase.py.

A property the float universe does not have: the Q15 accumulator is int32
with two's-complement wraparound, and wrapping addition is associative and
commutative mod 2^32 — so ANY summation order (serial C loop, NumPy
reduction, GEMM tree) produces bit-identical results.  The fixed universe is
therefore exactly reproducible on the device by construction, with no
accumulation-order caveats at all (contrast ops/fir_exact.py).

The device formulation lives in ops/fir_matmul.resample_conv_fixed; this
module is the semantics reference and the ResamplerCore single-stream path.
"""

from __future__ import annotations

import numpy as np

from . import filter_design as fd
from .fixed_math import (I32, interp_mix_fixed, saturate32pshr, to_word16)

__all__ = ["resample_fixed", "fixed_output_slice"]

_SLICE = 16384  # outputs per gather slice (bounds the [B, m, N] temporary)


def fixed_output_slice(X: np.ndarray, starts: np.ndarray,
                       phases: np.ndarray, spec: fd.FilterSpec) -> np.ndarray:
    """Exact fixed outputs for one slice.

    X: int16 [B, T] history-prefixed sample axis; starts/phases: int64 [m]
    window origins (indexed from X[0]) and fractional phases.  Returns
    int16 [B, m]."""
    N = spec.filt_len
    idx = starts[:, None] + np.arange(N, dtype=np.int64)[None, :]  # [m, N]
    win = X[:, idx].astype(I32)                                    # [B, m, N]
    if spec.use_direct:
        taps = spec.phase_rows(phases).astype(I32)                 # [m, N]
        with np.errstate(over="ignore"):
            s = (win * taps[None]).sum(axis=-1, dtype=I32)
        return to_word16(saturate32pshr(s, 15, 32767))
    w4, coef = spec.interp_rows(phases)        # [m, 4, N] / [m, 4] (lazy:
    w4 = w4.astype(I32)                        # huge-den specs compute just
    #                                            these rows, see FilterSpec)
    with np.errstate(over="ignore"):
        accum = (win[:, :, None, :] * w4[None]).sum(axis=-1, dtype=I32)
    return interp_mix_fixed(accum, coef[None])                     # [B, m]


def _native_fixed(X: np.ndarray, ls0: int, f0: int, n_out: int,
                  spec: fd.FilterSpec) -> np.ndarray | None:
    """Native (C++) twin of the NumPy slices below.  The Q15 accumulator
    is int32 with wraparound — order-free — so the vectorized native loop
    is bit-identical BY CONSTRUCTION (and differentially tested).  None
    when the native runtime is unavailable."""
    from ..runtime import native as rt
    if rt.load_runtime() is None:
        return None
    k = np.arange(n_out, dtype=np.int64)
    t = f0 + k * spec.num
    starts = ls0 + t // spec.den
    phases = t % spec.den
    if spec.use_direct:
        if spec._materialize_tables():
            return rt.fir_q15_direct(X, spec.phase_table, starts, phases)
        return rt.fir_q15_direct(X, spec.phase_rows(phases), starts, k)
    if spec._materialize_tables():
        return rt.fir_q15_interp(X, spec.interp_taps, spec.interp_coef,
                                 starts, phases)
    taps, coef = spec.interp_rows(phases)
    return rt.fir_q15_interp(X, taps, coef, starts, k)


def resample_fixed(X: np.ndarray, ls0: int, f0: int, n_out: int,
                   spec: fd.FilterSpec) -> np.ndarray:
    """X: int16 [B, T] (history ++ fresh samples); emits ``n_out`` outputs
    starting from state (ls0, f0).  Bit-exact vs the FIXED_POINT oracle."""
    assert spec.fixed_point, "float-universe specs use ops/fir_matmul"
    B = X.shape[0]
    if n_out <= 0:
        return np.zeros((B, 0), dtype=np.int16)
    num, den = spec.num, spec.den
    y = _native_fixed(X, ls0, f0, n_out, spec)
    if y is not None:
        return y
    outs = []
    for lo in range(0, n_out, _SLICE):
        hi = min(lo + _SLICE, n_out)
        k = np.arange(lo, hi, dtype=np.int64)
        t = f0 + k * num
        starts = ls0 + t // den
        phases = t % den
        outs.append(fixed_output_slice(X, starts, phases, spec))
    return np.concatenate(outs, axis=1)
