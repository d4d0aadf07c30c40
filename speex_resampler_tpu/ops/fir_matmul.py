"""Device hot path: the resampler as one phase-indexed matmul per launch.

Batched reformulation of the reference hot loops (resample.c:331-559).
Using the closed-form recurrence (ops/phase.py), outputs are grouped into
super-blocks of R = G*den outputs consuming exactly G*num inputs each, so a
launch is a single strided convolution

    Y[s, b, r] = sum_l X[s, b*G*num + l] * W[l, r]      (L = filt_len + G*num)

which XLA lowers to a GEMM.  The group factor G widens the matmul's
N-dimension for small ``den`` (e.g. integer upsampling, den=2) so each
block row carries enough output columns; W is the host-built padded weight
matrix
(ops/phase.build_padded_weights with R sub-phases).

A gather-based fallback handles pathological ratios whose padded weight
matrix would be too large (huge reduced denominators, e.g. 44100→44101).

Input samples ride as int16 end-to-end (the reference's float memory holds
exact s16 values, resample.c:1000-1006, so int16 state is lossless) and are
widened on-device; output applies WORD2INT (ops/convert.py) before leaving
as int16.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .convert import word2int

__all__ = ["choose_group", "resample_conv", "resample_conv_tm",
           "resample_gather", "MAX_PADDED_WEIGHT_BYTES",
           "fixed_weight_planes", "resample_conv_tm_fixed"]

# Above this padded-weight size the gather fallback is used instead.
MAX_PADDED_WEIGHT_BYTES = 32 * 1024 * 1024

_LANE_TARGET = 128  # GEMM width: output columns per block row to aim for


def choose_group(num: int, den: int, filt_len: int) -> int:
    """Pick the super-block group factor G (R = G*den output columns).

    Widens small-den configs toward 128 output columns while keeping the
    FLOP overhead L/filt_len = (filt_len + G*num)/filt_len bounded.
    """
    if den >= _LANE_TARGET:
        return 1
    g = -(-_LANE_TARGET // den)  # ceil
    # cap padding overhead: G*num <= 2*filt_len keeps L <= 3*filt_len
    while g > 1 and g * num > 2 * filt_len:
        g -= 1
    return max(g, 1)


@partial(jax.jit, static_argnames=("stride", "accum_dtype", "raw"))
def resample_conv(x, w, *, stride: int, accum_dtype=jnp.float32,
                  raw: bool = False):
    """One resample launch: strided patches × padded phase weights (GEMM).

    x: int16[batch, T]   input samples (history + chunk + zero pad), where
                         T = n_blocks * stride + L, T % stride == 0
    w: f32[L, R]         padded phase weights, L % stride == 0
    returns int16[batch, n_blocks*R] (callers slice off masked tail outputs).

    Patches P[b, l] = x[b*stride + l] are built without a gather: writing
    l = a*stride + d, P[b, a*stride+d] = reshape(x)[b+a, d], so P is a
    concat of A = L//stride shifted views of x.reshape(-1, stride) — pure
    reshape/slice/concat that XLA fuses into the matmul's operand reads.
    (A strided lax.conv spelling of the same math compiles to a very slow
    kernel on CPU; this form is a plain GEMM everywhere.)
    """
    L, R = w.shape
    batch, T = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    A = L // stride
    n_blocks = T // stride - A
    xr = x.reshape(batch, T // stride, stride)
    parts = [xr[:, a:a + n_blocks, :] for a in range(A)]
    patches = jnp.concatenate(parts, axis=2)           # [batch, B, L]
    pf = patches.reshape(batch * n_blocks, L).astype(jnp.float32)
    y = jnp.dot(pf, w.astype(jnp.float32),
                precision=lax.Precision.HIGHEST,
                preferred_element_type=accum_dtype)    # [batch*B, R]
    if raw:  # float-sample path (speex_resampler_process_float): no WORD2INT
        return y.astype(jnp.float32).reshape(batch, n_blocks * R)
    return word2int(y).reshape(batch, n_blocks * R)


@partial(jax.jit, static_argnames=("stride", "accum_dtype"))
def resample_conv_tm(x, w, *, stride: int, accum_dtype=jnp.float32):
    """Time-major twin of :func:`resample_conv` (same math, x transposed);
    the layout the batched engine uses.

    x: int16[T, B], T % stride == 0; w: f32[L, R], L % stride == 0.
    returns int16[n_blocks*R, B], n_blocks = T//stride - L//stride.
    """
    L, R = w.shape
    T, B = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    A = L // stride
    n_blocks = T // stride - A
    xr = x.reshape(T // stride, stride, B)
    wA = w.reshape(A, stride, R).transpose(0, 2, 1).astype(jnp.float32)
    acc = jnp.zeros((n_blocks, R, B), dtype=accum_dtype)
    for a in range(A):
        xa = lax.dynamic_slice_in_dim(xr, a, n_blocks, axis=0)
        acc = acc + jnp.einsum(
            "rs,nsb->nrb", wA[a], xa.astype(jnp.float32),
            precision=lax.Precision.HIGHEST,
            preferred_element_type=accum_dtype)
    return word2int(acc).reshape(n_blocks * R, B)


@partial(jax.jit, static_argnames=("tile", "accum_dtype", "raw"))
def resample_gather(x, taps, starts, *, tile: int = 2048,
                    accum_dtype=jnp.float32, raw: bool = False):
    """Fallback launch for huge-den ratios: per-output tap-row dots.

    x:      int16[batch, T]
    taps:   f32[n_out_padded, filt_len]   H rows pre-gathered by phase
    starts: int32[n_out_padded]           window starts (clamped in range)
    returns int16[batch, n_out_padded]
    """
    n_out, filt_len = taps.shape
    xf = x.astype(jnp.float32)
    batch = xf.shape[0]
    n_tiles = n_out // tile
    assert n_tiles * tile == n_out, "caller pads n_out to a tile multiple"

    def do_tile(args):
        s, t = args                                    # [tile], [tile, N]
        idx = s[:, None] + jnp.arange(filt_len, dtype=s.dtype)[None, :]
        win = xf[:, idx].astype(accum_dtype)           # [batch, tile, N]
        return jnp.einsum("bon,on->bo", win, t.astype(accum_dtype),
                          precision=lax.Precision.HIGHEST)

    y = lax.map(do_tile, (starts.reshape(n_tiles, tile),
                          taps.reshape(n_tiles, tile, filt_len)))
    y = jnp.moveaxis(y, 1, 0).reshape(batch, n_out)
    if raw:
        return y.astype(jnp.float32)
    return word2int(y)


# ---------------------------------------------------------------------------
# FIXED_POINT universe device path.
#
# The fixed hot loops accumulate int16*int16 products in a wrapping int32
# (resample.c:331-384/:438-496, FIXED_POINT branches).  Wrapping addition is
# associative mod 2^32, so ANY regrouping — including a GEMM's — is
# bit-exact.  An int16 x int16 -> int32 dot decomposes EXACTLY into four
# int8 x int8 -> int32 dots plus one host-constant bias:
#
#     w = 256*wh + wl0 EXACTLY (realizable Q15 taps satisfy
#         |w| <= 32768*cutoff < 32639, so the balanced split
#         wl0 = ((w+128) & 255) - 128, wh = (w - wl0) >> 8 fits int8
#         with no constant term; zero padding decomposes to (0, 0))
#     x = 256*xh + (xl0 + 128)   (data spans the full int16 range)
#     sum_L w*x = [65536*wh.xh + 256*(wh.xl0 + wl0.xh) + wl0.xl0]
#               + 128*sum_L(w)                                   (mod 2^32)
#
# 128*sum_L(w) is a host constant per output column.  Per-plane int8 dot
# sums are bounded by 16384*L < 2^31 for every realizable L, so the int32
# accumulators never wrap mid-plane; all combining is int32 (wraps exactly
# like the C accumulator).  The dots must stay integer: a lowering through
# float32 would round sums past 2^24.
# ---------------------------------------------------------------------------


def fixed_weight_planes(w16: "np.ndarray"):
    """Host-side EXACT balanced plane decomposition of an int16 weight
    matrix (fixed_math.balanced_q15_split).

    w16: int16 [L, C] (C = R direct columns, or 4*R interp accumulator
    columns).  Returns (wh int8[L,C], wl0 int8[L,C], bias int32[C]) with
    w = 256*wh + wl0 exactly and bias[c] = 128 * sum_L w16[l, c] (the
    contribution of the input's +128 plane)."""
    from .fixed_math import balanced_q15_split
    return balanced_q15_split(w16, tap_axis=0)


def _exact_i16_dot(xa, wh_a, wl0_a):
    """One a-slice's exact plane contraction (bias added by the caller).

    xa: int16 [n, s, B]; wh_a/wl0_a: int8 [C, s].  Returns int32 [n, C, B]
    = sum_s w * (x - 128) contributions (w = 256*wh + wl0 exactly; the
    input's +128 plane is the caller's host-constant bias)."""
    xh = (xa >> 8).astype(jnp.int8)
    xl0 = ((xa & 255) - 128).astype(jnp.int8)

    def dot(wp, xp):
        return jnp.einsum("cs,nsb->ncb", wp, xp,
                          preferred_element_type=jnp.int32)

    hh = dot(wh_a, xh)
    hl = dot(wh_a, xl0)
    lh = dot(wl0_a, xh)
    ll = dot(wl0_a, xl0)
    return (hh << 16) + ((hl + lh) << 8) + ll


def _interp_mix_jax(accum, coef):
    """Fixed interpolate epilogue, trailing-axis layout (canonical algebra
    from ops/fixed_math jnp twins).

    accum: int32 [..., 4]; coef: int32 [..., 4] (int16 values).  Returns
    int16 [...]: sum_k MULT16_32_Q15(coef_k, accum_k >> 1), saturated."""
    from .fixed_math import mult16_32_q15_jax, sat32pshr15_jax
    terms = mult16_32_q15_jax(coef, accum >> 1)
    s = terms[..., 0] + terms[..., 1] + terms[..., 2] + terms[..., 3]
    return sat32pshr15_jax(s)


@partial(jax.jit, static_argnames=("stride", "n_accum"))
def resample_conv_tm_fixed(x, w_planes, *, stride: int, n_accum: int = 1):
    """FIXED_POINT launch, time-major dense geometry (bit-exact).

    x:        int16 [T, B], T % stride == 0
    w_planes: (wh int8[L, C], wl0 int8[L, C], bias int32[C][, coef
              int32[R, 4]]) from fixed_weight_planes (+ per-column Q15
              cubic coefficients when n_accum == 4), L % stride == 0,
              C = n_accum * R
    returns   int16 [n_blocks*R, B]

    n_accum == 1: direct path — epilogue SATURATE32PSHR(sum, 15, 32767).
    n_accum == 4: interpolated path — four explicit accumulator columns per
    output (column order c-minor: column r*4+k is accumulator k of output
    r), mixed with the exact integer cubic epilogue.
    """
    if n_accum == 4:
        wh, wl0, bias, coef = w_planes
    else:
        wh, wl0, bias = w_planes
    L, C = wh.shape
    T, B = x.shape
    assert T % stride == 0 and L % stride == 0, (T, L, stride)
    A = L // stride
    n_blocks = T // stride - A

    xr = x.reshape(T // stride, stride, B)
    whA = wh.reshape(A, stride, C).transpose(0, 2, 1)   # [A, C, s]
    wlA = wl0.reshape(A, stride, C).transpose(0, 2, 1)
    acc = jnp.zeros((n_blocks, C, B), dtype=jnp.int32)
    for a in range(A):
        xa = lax.dynamic_slice_in_dim(xr, a, n_blocks, axis=0)
        acc = acc + _exact_i16_dot(xa, whA[a], wlA[a])

    s = acc + bias[None, :, None]

    if n_accum == 4:
        R = C // 4
        s4 = s.reshape(n_blocks, R, 4, B).transpose(0, 1, 3, 2)
        y = _interp_mix_jax(s4, coef[None, :, None, :])  # [n_blocks, R, B]
    else:
        from .fixed_math import sat32pshr15_jax
        y = sat32pshr15_jax(s)
    return y.reshape(n_blocks * (C // n_accum), B)


@partial(jax.jit, static_argnames=("tile",))
def resample_gather_fixed(x, taps, starts, coef=None, *, tile: int = 2048):
    """FIXED_POINT gather fallback: exact on-device per-output tap-row dots
    for pathological huge-den ratios (e.g. 44100->44101, where any padded/
    cyclic weight matrix would be GBs; resample.c:331-384/:438-496 fixed
    branches).

    x:      int16[batch, T]
    taps:   int16[n_pad, N] (direct table rows) or int16[n_pad, 4, N]
            (interpolated accumulator rows), pre-gathered by phase
    starts: int32[n_pad] clamped window origins
    coef:   int32[n_pad, 4] Q15 cubic coefficients (interpolated path)
    returns int16[batch, n_pad]

    All accumulation is wrapping int32 via explicit elementwise multiply +
    sum (no integer dot_general lowering in the path), so the result is
    bit-exact vs the C accumulator in ANY order — exactness by
    construction, like resample_conv_tm_fixed.  Rare serving path.
    """
    from .fixed_math import sat32pshr15_jax
    n_out, N = taps.shape[0], taps.shape[-1]
    xi = x.astype(jnp.int32)
    n_tiles = n_out // tile
    assert n_tiles * tile == n_out, "caller pads n_out to a tile multiple"
    interp = taps.ndim == 3

    def do_tile(args):
        if interp:
            s, t, c = args            # [tile], [tile, 4, N], [tile, 4]
        else:
            s, t = args               # [tile], [tile, N]
        idx = s[:, None] + jnp.arange(N, dtype=s.dtype)[None, :]
        win = xi[:, idx]                              # [batch, tile, N]
        if interp:
            acc = (win[:, :, None, :] * t.astype(jnp.int32)[None]
                   ).sum(axis=-1)                     # [batch, tile, 4]
            return _interp_mix_jax(acc, c[None].astype(jnp.int32))
        acc = (win * t.astype(jnp.int32)[None]).sum(axis=-1)
        return sat32pshr15_jax(acc)

    if interp:
        ops = (starts.reshape(n_tiles, tile),
               taps.reshape(n_tiles, tile, 4, N),
               coef.reshape(n_tiles, tile, 4))
    else:
        ops = (starts.reshape(n_tiles, tile),
               taps.reshape(n_tiles, tile, N))
    y = lax.map(do_tile, ops)
    return jnp.moveaxis(y, 1, 0).reshape(x.shape[0], n_out)
