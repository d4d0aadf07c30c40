"""Pure-functional JAX API: embed the resampler in your own jitted graph.

The stateful engines (``BatchedResampler``/``FleetResampler``) own staging,
accounting, and degradation; this module exposes the underlying pure step
for users who want resampling as one stage of their OWN ``jit``/``pjit``
pipeline — an on-device audio data-loading or feature-extraction graph,
a model front-end, a TTS back-end.  This has no reference counterpart
(the reference is a host-callable state machine, resample.c:878-1082);
it is the idiomatic-JAX face of the same launch-invariant step the
engines run (see docs/design.md "Launch-invariant phase").

Semantics: ``step`` consumes EXACTLY ``in_frames`` input frames per call
and produces EXACTLY ``out_frames`` — the launch quantum is a multiple of
the reduced ratio's numerator, so the fractional phase returns to its
start after every call and one compiled function serves the stream
forever with static shapes.  Outputs are identical to the reference C
core processing the same stream (≤1 LSB float / bit-exact fixed; the
filter's leading delay is included, as with a fresh C state).

Example::

    import jax, jax.numpy as jnp
    from speex_resampler_tpu.functional import make_stream_fn

    rs = make_stream_fn(44100, 48000, quality=7)

    @jax.jit
    def pipeline(hist, pcm_i16):          # pcm [rs.in_frames, B] int16
        hist, y = rs.step(hist, pcm_i16)  # y   [rs.out_frames, B] int16
        rms = jnp.sqrt(jnp.mean(jnp.square(y.astype(jnp.float32)), 0))
        return hist, y, rms               # resample + features, one launch

    hist = rs.init(batch=16)
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from .ops import filter_design as fd
from .parallel.batch import (_launch_geometry, make_batched_step,
                             BatchedResampler)

__all__ = ["StreamFn", "make_stream_fn", "resample_array"]


@dataclasses.dataclass(frozen=True)
class StreamFn:
    """A pure resampling step plus its shape contract.

    step(hist i16[hist_rows, B], x i16[in_frames, B])
        -> (hist' i16[hist_rows, B], y i16[out_frames, B])

    ``B`` is free: lanes = streams x channels, share-nothing, so any batch
    size works (each new B re-traces once).  ``step`` is jittable and may
    be called inside an outer ``jax.jit`` — weights are closed over as
    constants; under a ``mesh`` they are replicated and the lane axis is
    sharded (pass sharded ``hist``/``x``).
    """
    step: object
    in_frames: int           # input frames consumed per call
    out_frames: int          # output frames produced per call
    hist_rows: int           # history rows carried between calls
    input_latency: int       # filter delay, input samples (filt_len/2)
    output_latency: int      # filter delay, output samples
    fixed_point: bool

    def init(self, batch: int) -> jax.Array:
        """Fresh-stream history (zeros) for ``batch`` lanes."""
        return jnp.zeros((self.hist_rows, batch), dtype=jnp.int16)


def make_stream_fn(in_rate: int, out_rate: int, quality: int = 7, *,
                   target_in_frames: int = 4096,
                   fixed_point: bool = False,
                   mesh: "jax.sharding.Mesh | None" = None) -> StreamFn:
    """Build a pure step for one config.

    ``target_in_frames`` sizes the launch quantum (rounded to the
    geometry's stride); larger quanta amortize launch overhead, smaller
    ones cut availability latency — same trade as the engines'
    ``target_chunk_frames``.
    """
    g = math.gcd(in_rate, out_rate)
    spec = fd.design_filter(in_rate // g, out_rate // g, quality,
                            fixed_point=fixed_point)
    bspec = _launch_geometry(spec, target_in_frames)
    bstep = make_batched_step(spec, bspec, mesh=mesh)
    n_in = bspec.in_per_launch
    pad_rows = bstep.chunk_rows - n_in
    fn, w = bstep.fn, bstep.w

    def step(hist, x):
        if x.shape[0] != n_in:
            raise ValueError(
                f"step consumes exactly {n_in} frames/call, got {x.shape}")
        # rows [n_in, n_in+zero_tail) must be zero; the rest are
        # don't-care — zero-padding satisfies both (static shapes)
        xp = jnp.pad(x.astype(jnp.int16), ((0, pad_rows), (0, 0)))
        return fn(hist, xp, w)

    return StreamFn(
        step=step, in_frames=n_in, out_frames=bspec.out_per_launch,
        hist_rows=bstep.hist_rows,
        input_latency=spec.filt_len // 2,
        output_latency=((spec.filt_len // 2) * spec.den
                        + (spec.num >> 1)) // spec.num,
        fixed_point=fixed_point)


def resample_array(x: np.ndarray, in_rate: int, out_rate: int,
                   quality: int = 7, *, fixed_point: bool = False) -> np.ndarray:
    """One-shot host convenience: resample a whole finite signal.

    ``x``: int16, shape [n] (one mono stream), [n, C] (one stream), or
    [S, n, C] (a batch).  Returns every producible output frame including
    the flush tail — i.e. the stream processed to completion, like
    pushing the whole buffer through the engine and flushing.
    """
    x = np.asarray(x, dtype=np.int16)
    squeeze = 0
    if x.ndim == 1:
        x, squeeze = x[None, :, None], 2
    elif x.ndim == 2:
        x, squeeze = x[None], 1
    elif x.ndim != 3:
        raise ValueError(f"expected [n], [n, C] or [S, n, C], got {x.shape}")
    S, n, C = x.shape
    eng = BatchedResampler(S, C, in_rate, out_rate, quality,
                           target_chunk_frames=min(max(n, 1), 1 << 16),
                           fixed_point=fixed_point)
    out = np.concatenate([eng.process(x), eng.flush()], axis=1)
    if squeeze == 2:
        return out[0, :, 0]
    return out[0] if squeeze else out
