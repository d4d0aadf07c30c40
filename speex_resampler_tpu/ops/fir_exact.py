"""Accumulation-order-faithful direct-path resampler (host, NumPy).

The batched device kernels regroup the f32 accumulation (GEMM tree order), so
their outputs can differ from the reference by rounding ties within 1 LSB.
This module reproduces the reference's DIRECT-path hot loops with the
EXACT C arithmetic order, yielding bit-identical output — a strictly
stronger exactness claim, asserted with zero tolerated mismatches in
tests/test_exact_direct.py:

 - direct single (resample.c:331-384): per output, serial f32
   ``sum += sinct[j]*iptr[j]`` over the filt_len taps (float build:
   MULT16_16 is a plain f32 multiply, SATURATE32PSHR an identity).
   Vectorised over outputs, serial over taps — identical per-output
   rounding sequence.
 - direct double (resample.c:389-436, selected when quality > 8): four
   f64 accumulators filled j%4-interleaved with f32 products, combined
   ((a0+a1)+a2)+a3 in f64, narrowed to f32 at the output store.
 - interpolate single (resample.c:438-496, float macros): four f32
   accumulators (one f32 product + add per tap), f32 cubic coefficients,
   left-associated f32 mix i0*a0 + i1*a1 + i2*a2 + i3*a3.
 - interpolate double (quality > 8, resample.c:501-559): f64 accumulators
   over f32 products (MULT16_16 casts both operands to spx_word32_t =
   float, arch.h:180 — the ``double curr_in`` is narrowed right back),
   f64 mix narrowed to f32 at the store (``spx_word32_t sum`` is float).

Entry points: ``resample_exact_state`` (stream-state-aware, the core's
exact=True serving path) and the one-shot wrappers ``resample_exact`` /
``resample_direct_exact``.

Both paths end in WORD2INT (arch.h:208-209) exactly as process_int does
(resample.c:1018-1023).
"""

from __future__ import annotations

import numpy as np

from . import filter_design as fd
from .convert import word2int_np as word2int

__all__ = ["resample_direct_exact", "resample_exact",
           "resample_exact_state"]

_SLICE = 16384  # outputs per slice (bounds the [m, N, 4] tap gather)


def resample_direct_exact(frames: np.ndarray, in_rate: int, out_rate: int,
                          quality: int) -> np.ndarray:
    """One-shot order-exact resample on a DIRECT-path config (back-compat
    wrapper over resample_exact)."""
    import math
    g = math.gcd(in_rate, out_rate)
    spec = fd.design_filter(in_rate // g, out_rate // g, quality)
    assert spec.use_direct, "direct wrapper used on an interpolated config"
    return resample_exact(frames, in_rate, out_rate, quality)


def resample_exact(frames: np.ndarray, in_rate: int, out_rate: int,
                   quality: int) -> np.ndarray:
    """One-shot order-exact resample of int16 [n, C] frames on ANY config
    (hot-loop variant selected per resample.c:680-699); returns int16
    [m, C] bit-identical to the reference float build."""
    import math
    g = math.gcd(in_rate, out_rate)
    spec = fd.design_filter(in_rate // g, out_rate // g, quality)
    N = spec.filt_len
    X = np.concatenate(
        [np.zeros((frames.shape[1], N - 1), np.float32),
         np.ascontiguousarray(frames.T).astype(np.float32)], axis=1)
    n_out = (frames.shape[0] * spec.den + spec.num - 1) // spec.num
    y = resample_exact_state(X, 0, 0, n_out, spec)
    return np.ascontiguousarray(y.T)


# ---------------------------------------------------------------------------
# State-aware streaming entry (round 2): the same four order-faithful hot
# loops, driven from arbitrary stream state (ls0, f0) over a
# history-prefixed sample axis — the signature the stateful core uses, so
# SpeexResampler(exact=True) can serve bit-identical output through the
# normal chunked pipeline (magic samples, set_rate, capacities included).
# ---------------------------------------------------------------------------


def _direct_slice(X, starts, phases, taps, *, double: bool,
                  raw: bool) -> np.ndarray:
    """X f32 [B, T]; per-output direct dot with C accumulation order."""
    N = taps.shape[1]
    tp = taps[phases]                                   # [m, N]
    if double:
        acc4 = np.zeros((4, X.shape[0], starts.shape[0]), dtype=np.float64)
        for j in range(N):
            prod = (tp[:, j][None, :] * X[:, starts + j])
            acc4[j % 4] += prod.astype(np.float64)
        s = (((acc4[0] + acc4[1]) + acc4[2]) + acc4[3]).astype(np.float32)
    else:
        s = np.zeros((X.shape[0], starts.shape[0]), dtype=np.float32)
        for j in range(N):
            s += tp[:, j][None, :] * X[:, starts + j]
    return s if raw else word2int(s)


def _interp_slice(X, starts, phases, spec, *, double: bool,
                  raw: bool) -> np.ndarray:
    """X f32 [B, T]; per-output interpolated 4-accumulator mix."""
    ov, den = spec.oversample, spec.den
    prod = (phases * ov) & 0xFFFFFFFF                   # uint32 wrap
    offset = (prod // den).astype(np.int64)
    rem = (prod % den).astype(np.int64)
    frac = (rem.astype(np.float32) / np.float32(den)).astype(np.float32)
    interp = fd.cubic_coef(frac)                        # [m, 4]
    T = np.asarray(spec.sinc_table, np.float32)
    N = spec.filt_len
    adt = np.float64 if double else np.float32
    acc = np.zeros((4, X.shape[0], starts.shape[0]), dtype=adt)
    for j in range(N):
        base = 4 + (j + 1) * ov - offset - 2
        xj = X[:, starts + j]
        for k in range(4):
            # MULT16_16 narrows both operands to float (arch.h:180), so
            # products are f32 in BOTH variants; only the += widens
            acc[k] += (xj * T[base + k][None, :]).astype(np.float32)
    i = interp.astype(adt)
    s = (((i[:, 0][None] * acc[0] + i[:, 1][None] * acc[1])
          + i[:, 2][None] * acc[2]) + i[:, 3][None] * acc[3])
    s = s.astype(np.float32)
    return s if raw else word2int(s)


def _native_exact(X: np.ndarray, starts: np.ndarray, phases: np.ndarray,
                  spec, double: bool) -> np.ndarray | None:
    """Native (C++) twin of the slice loops below — same accumulation
    orders compiled -ffp-contract=off, so the output is bit-identical;
    returns None when the native runtime is unavailable (callers fall
    back to the NumPy loops, which remain the semantics reference)."""
    from ..runtime import native as rt
    if rt.load_runtime() is None:
        return None
    if spec.use_direct:
        if spec._materialize_tables():
            # canonical recurrence holds -> phase-grouped vector path
            return rt.fir_f32_direct(X, np.asarray(spec.phase_table,
                                                   np.float32),
                                     starts, phases, double,
                                     num=spec.num, den=spec.den)
        # huge-den lazy spec: gather just the rows in flight
        taps = spec.phase_rows(phases)
        ph = np.arange(len(phases), dtype=np.int64)
        return rt.fir_f32_direct(X, np.asarray(taps, np.float32),
                                 starts, ph, double)
    ov, den = spec.oversample, spec.den
    offset = ((phases * ov) & 0xFFFFFFFF) // den
    if len(offset) and int(offset.max()) > ov + 2:
        # uint32 wrap regime (den >= 65537) can push tap indices outside
        # the table; the NumPy path defines that gather, stay on it
        return None
    return rt.fir_f32_interp(X, np.asarray(spec.sinc_table, np.float32),
                             ov, den, spec.filt_len, starts, phases,
                             double)


def resample_exact_state(X: np.ndarray, ls0: int, f0: int, n_out: int,
                         spec, *, raw: bool = False) -> np.ndarray:
    """X: f32 [B, T] (history ++ fresh samples, reference ``mem`` layout);
    emits ``n_out`` outputs from state (ls0, f0) with the reference's
    EXACT accumulation order (hot-loop variant selected per
    resample.c:680-699).  raw=True returns the pre-WORD2INT f32 sums
    (the process_float path, resample.c:953-958)."""
    B = X.shape[0]
    if n_out <= 0:
        return np.zeros((B, 0), dtype=np.float32 if raw else np.int16)
    X = np.asarray(X, dtype=np.float32)
    double = spec.quality > 8
    t_all = f0 + np.arange(n_out, dtype=np.int64) * spec.num
    y = _native_exact(X, ls0 + t_all // spec.den,
                      (t_all % spec.den).astype(np.int64), spec, double)
    if y is not None:
        return y if raw else word2int(y)
    outs = []
    for lo in range(0, n_out, _SLICE):
        hi = min(lo + _SLICE, n_out)
        t = f0 + np.arange(lo, hi, dtype=np.int64) * spec.num
        starts = ls0 + t // spec.den
        phases = (t % spec.den).astype(np.int64)
        if spec.use_direct:
            outs.append(_direct_slice(X, starts, phases,
                                      spec.phase_table.astype(np.float32),
                                      double=double, raw=raw))
        else:
            outs.append(_interp_slice(X, starts, phases, spec,
                                      double=double, raw=raw))
    return np.concatenate(outs, axis=1)
