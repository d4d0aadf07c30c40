"""Batched multi-stream serving engine — the device hot path.

The reference processes one stream per ``SpeexResamplerState`` with a serial
per-channel loop (resample.c:1061-1082); concurrency is left to the caller.
Here, S concurrent streams × C channels become one batch axis of B = S*C
independent lanes resampled in a single device launch (the flagship
deployment: 1024 concurrent stereo streams, 2048 lanes, per launch).

Steady-state design: every launch consumes a fixed quantum of input frames
per lane that is a multiple of ``num``.  Because ``den`` outputs always
consume exactly ``num`` inputs, the fractional phase ``samp_frac_num`` and
the relative window origin return to their initial values after every
launch — so the compiled step function has fully static shapes and constant
weights, and one XLA program serves the engine forever (time-major):

    step: (hist i16[H, B], x i16[chunk_rows, B]) -> (hist', y i16[n_out, B])

(see BatchedStep for the buffer contract).  The only host↔device traffic is
the s16 chunk in and the s16 result out (4 bytes/sample total — the same
two copies the reference makes across the wasm heap,
src/index.ts:92,111-115).

An internal staging buffer accumulates arbitrary caller chunk sizes up to
the launch quantum.  Output samples are identical to per-chunk processing
(chunking-invariance is asserted by tests/test_streaming.py); only
availability latency changes, bounded by one launch quantum.

Multi-chip scaling: streams are embarrassingly parallel, so the engine
optionally shards the lane axis across a ``jax.sharding.Mesh`` — data
parallelism with zero collectives in the math (SURVEY.md §5).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import filter_design as fd
from ..ops import phase as ph
from ..ops import fir_matmul as fm
from ..utils.degrade import ZeroFillDegradation
from ..utils.errors import ResamplerError, ResamplerErrorCode

__all__ = ["BatchedResampler", "make_batched_step", "BatchSpec"]


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """Static launch geometry for one (ratio, quality) config.

    kernel == "dense": super-blocks of R = group*den outputs consuming
    group*num inputs each, one GEMM per launch (ops/fir_matmul.py layout).
    kernel == "gather": pathological huge-den ratios (e.g. 44100->44101)
    whose padded weight matrix would be GBs; per-output tap rows are
    gathered host-side once and the launch is a per-tile dot
    (fm.resample_gather / fm.resample_gather_fixed).
    """
    num: int
    den: int
    quality: int
    filt_len: int
    group: int          # super-block factor G
    n_blocks: int       # super-blocks per launch
    f0: int             # fractional phase at every launch start
    kernel: str = "dense"

    @property
    def stride(self) -> int:
        return self.group * self.num

    @property
    def in_per_launch(self) -> int:
        """Input frames consumed per lane per launch."""
        return self.n_blocks * self.stride

    @property
    def out_per_launch(self) -> int:
        """Output frames produced per lane per launch."""
        return self.n_blocks * self.group * self.den


def _dense_weight_bytes(spec: fd.FilterSpec, group: int) -> int:
    L = spec.filt_len + group * spec.num
    # fixed-universe dense weights are two int8 digit planes (~2 B/entry),
    # float is f32 (4 B/entry)
    itemsize = 2 if spec.fixed_point else 4
    return L * group * spec.den * itemsize


def _adapt_hist(hist, rows: int, filt_len: int, cols: int) -> np.ndarray:
    """Re-layout a checkpointed filter history to THIS engine's hist-row
    geometry.  Valid history always occupies the LAST filt_len-1 rows
    (leading rows, if any, are alignment padding), so a checkpoint whose
    history carries extra leading rows — older checkpoints were written
    with filt_len-1 rounded up to 16 — restores losslessly.  A geometry
    that cannot be adapted raises INVALID_ARG instead of being accepted
    and failing inside the first dispatch (where the degradation guard
    would turn it into permanent silent zero output)."""
    # np.array (copy), not asarray: a jnp-backed checkpoint hist would
    # alias as a READ-ONLY view and break degraded-mode slot writes
    hist = np.array(hist, dtype=np.int16)
    keep = filt_len - 1
    if hist.ndim != 2 or hist.shape[1] != cols or hist.shape[0] < keep:
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    if hist.shape[0] == rows:
        return hist
    out = np.zeros((rows, cols), dtype=np.int16)
    if keep:
        out[rows - keep:] = hist[hist.shape[0] - keep:]
    return out


@dataclasses.dataclass(frozen=True)
class BatchedStep:
    """Compiled steady-state step + its launch buffer contract.

    fn(hist i16[hist_rows, B], x i16[chunk_rows, B], w)
        -> (hist' i16[hist_rows, B], y i16[out_per_launch, B])
    x rows [0, in_per_launch) are the chunk; rows
    [in_per_launch, in_per_launch + zero_tail) must be zero; any further
    rows are don't-care padding (read but multiplied by zero weights).
    """
    fn: object
    w: object
    hist_rows: int
    chunk_rows: int
    zero_tail: int


def compile_step(fn, *args) -> None:
    """Compile ``fn`` for these operands before the first launch.

    A step the device cannot lower or compile raises ALLOC_FAILED here,
    at engine construction (C's init fails the same way when
    update_filter cannot allocate, resample.c:785-791).  Left to the
    first dispatch, the error would trip the zero-fill degradation guard
    and turn the engine into permanent silent zero output.  jit reuses
    the executable for later calls with the same operand signature."""
    try:
        fn.lower(*args).compile()
    except Exception as e:
        raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED) from e


def _gather_blocks(spec: fd.FilterSpec, target_in_frames: int,
                   hard_cap: bool = False) -> int:
    """Gather-geometry block count: one block = num inputs -> den outputs.
    Bounded so the launch's OUTPUT stays sane for absurd upsample ratios
    (den in the tens of millions is legal in the reference — it streams
    per-sample — but n_blocks*den output rows must not explode the host/
    device buffers; ~4M output frames per launch is plenty of batching).
    ``hard_cap`` floors instead of rounding: a max_latency_ms budget is a
    ceiling the quantum must not cross."""
    max_blocks = max(1, _MAX_GATHER_OUT_FRAMES // spec.den)
    want = (target_in_frames // spec.num if hard_cap
            else round(target_in_frames / spec.num))
    return max(1, min(want, max_blocks))


_MAX_GATHER_OUT_FRAMES = 1 << 22


def _launch_geometry(spec: fd.FilterSpec, target_in_frames: int,
                     f0: int = 0,
                     max_in_frames: int | None = None) -> BatchSpec:
    """Static launch geometry.  ``max_in_frames`` is a HARD cap on the
    launch quantum (the engine's availability latency).

    The cap wraps the uncapped choice: if rounding pushed the quantum past
    the cap, the gather geometry floors its block count and the dense
    geometry shrinks its group factor to fit (minimum quantum = num
    frames — one output period).  A permissive cap never changes the
    uncapped geometry.  Raises INVALID_ARG when even one period exceeds
    the cap (f0-invariant batching cannot go below num inputs)."""
    if max_in_frames is None:
        return _uncapped_geometry(spec, target_in_frames, f0)
    if spec.num > max_in_frames:
        # one den-outputs-per-num-inputs period is the floor of
        # phase-invariant batching; tighter budgets need the
        # single-stream core (ResamplerCore processes sample-by-sample)
        raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
    bspec = _uncapped_geometry(spec, min(target_in_frames, max_in_frames),
                               f0)
    if bspec.in_per_launch <= max_in_frames:
        return bspec
    if bspec.kernel == "gather":
        return dataclasses.replace(
            bspec, n_blocks=_gather_blocks(spec, max_in_frames,
                                           hard_cap=True))
    group = min(bspec.group, max(1, max_in_frames // spec.num))
    return dataclasses.replace(
        bspec, group=group,
        n_blocks=max(1, max_in_frames // (group * spec.num)))


def _uncapped_geometry(spec: fd.FilterSpec, target_in_frames: int,
                       f0: int) -> BatchSpec:
    group = fm.choose_group(spec.num, spec.den, spec.filt_len)
    geom = dict(num=spec.num, den=spec.den, quality=spec.quality,
                filt_len=spec.filt_len, f0=f0)
    if _dense_weight_bytes(spec, group) > fm.MAX_PADDED_WEIGHT_BYTES:
        # pathological huge-den ratio: any padded weight matrix is GBs —
        # fall to the weight-free gather geometry (one quantum of num
        # inputs -> den outputs per block)
        return BatchSpec(group=1, kernel="gather",
                         n_blocks=_gather_blocks(spec, target_in_frames),
                         **geom)
    n_blocks = max(1, round(target_in_frames / (group * spec.num)))
    return BatchSpec(group=group, n_blocks=n_blocks, **geom)


# Per-process memo for built steps: every make_batched_step call used to
# jit a FRESH closure, so jax's trace cache (keyed on function identity)
# missed even for an identical config — a MultiFleet bucket rebuilt after
# idle-LRU eviction paid a full XLA retrace+compile.  BatchedStep is
# frozen and its weights are read-only device arrays, so instances are
# safely shared across engine incarnations.  Keyed on the full geometric
# identity of the design (num/den/quality/universe/direct-vs-interpolated
# — design_filter is deterministic in these) + launch geometry +
# trace-shaping knobs.  Size-bounded by total weight bytes AND entry count
# (LRU).
_STEP_CACHE: "collections.OrderedDict[tuple, BatchedStep]" = \
    collections.OrderedDict()
_STEP_CACHE_LOCK = threading.Lock()
_STEP_CACHE_MAX_ENTRIES = 16
_STEP_CACHE_MAX_BYTES = 256 * 1024 * 1024


def _step_weight_bytes(step: BatchedStep) -> int:
    return sum(getattr(leaf, "nbytes", 0)
               for leaf in jax.tree_util.tree_leaves(step.w))


def clear_step_cache() -> None:
    """Drop all memoized steps (frees their device weight arrays)."""
    with _STEP_CACHE_LOCK:
        _STEP_CACHE.clear()


def make_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                      mesh: jax.sharding.Mesh | None = None,
                      axis: str = "streams",
                      lane_major: bool = False) -> BatchedStep:
    """Memoizing front-end for :func:`_build_batched_step` (see its
    docstring for the step contract).  Mesh-wrapped steps bypass the memo
    (mesh identity is caller-owned)."""
    if mesh is not None:
        return _build_batched_step(spec, bspec, mesh=mesh, axis=axis,
                                   lane_major=lane_major)
    key = (spec.num, spec.den, spec.quality, spec.fixed_point,
           spec.use_direct, spec.filt_len, spec.oversample, bspec,
           bool(lane_major), jax.default_backend())
    with _STEP_CACHE_LOCK:
        hit = _STEP_CACHE.get(key)
        if hit is not None:
            _STEP_CACHE.move_to_end(key)
            return hit
    # build outside the lock: concurrent misses on DIFFERENT configs must
    # not serialize behind one compile (duplicate builds of the SAME key
    # are benign — first insert wins)
    step = _build_batched_step(spec, bspec, lane_major=lane_major)
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = step
        _STEP_CACHE.move_to_end(key)
        total = sum(_step_weight_bytes(s) for s in _STEP_CACHE.values())
        while _STEP_CACHE and (
                len(_STEP_CACHE) > _STEP_CACHE_MAX_ENTRIES
                or total > _STEP_CACHE_MAX_BYTES):
            _, old = _STEP_CACHE.popitem(last=False)
            total -= _step_weight_bytes(old)
        return _STEP_CACHE.get(key, step)


def _gather_starts(spec: fd.FilterSpec, bspec: BatchSpec, n_out: int,
                   tile: int):
    """Per-output window starts and phases of the gather geometry, padded
    to a whole number of ``tile``-output tiles (starts clamped in range)."""
    n_pad = max(-(-n_out // tile) * tile, tile)
    t = bspec.f0 + np.arange(n_pad, dtype=np.int64) * spec.num
    T = spec.filt_len - 1 + bspec.in_per_launch
    starts = np.minimum(t // spec.den, max(T - spec.filt_len, 0))
    return starts.astype(np.int32), (t % spec.den).astype(np.int64)


def _build_batched_step(spec: fd.FilterSpec, bspec: BatchSpec, *,
                        mesh: jax.sharding.Mesh | None = None,
                        axis: str = "streams",
                        lane_major: bool = False) -> BatchedStep:
    """Build the jitted steady-state step function.

    Float configs run fm.resample_conv_tm (f32 GEMM at
    Precision.HIGHEST); FIXED_POINT configs run the exact int8-plane
    fm.resample_conv_tm_fixed; huge-den ratios run the gather twins.

    Time-major layout (lanes on the minor axis).  ``B`` is free (any batch
    size re-traces once per size).  The weight matrix rides as an operand
    so shardings propagate (it is replicated under a mesh; history/x/y
    shard on their lane axis).

    With ``mesh``, the step is wrapped in ``shard_map`` over the lane axis:
    streams are share-nothing, so each device runs the step on its lane
    shard with zero collectives.
    """
    N = spec.filt_len
    n_in = bspec.in_per_launch
    n_out = bspec.out_per_launch

    def _wrap(step_impl):
        if lane_major:
            # Serving layout: the host stages LANE-MAJOR [B, rows] slabs
            # (contiguous per-stream gather/scatter, runtime/native.py
            # *_lm) and both transposes ride the device inside this jit,
            # where they are HBM-bandwidth trivial.  hist stays
            # time-major (it never crosses the host boundary per launch).
            inner = step_impl

            def step_impl(hist, x_lm, w):
                h2, y = inner(hist, x_lm.T, w)
                return h2, y.T
        if mesh is None:
            return jax.jit(step_impl)
        P = jax.sharding.PartitionSpec
        xy = P(axis, None) if lane_major else P(None, axis)
        return jax.jit(jax.shard_map(
            step_impl, mesh=mesh,
            in_specs=(P(None, axis), xy, P()),
            out_specs=(P(None, axis), xy),
            check_vma=False))

    if bspec.kernel == "gather":
        # pathological huge-den ratios: weight-free per-output tap gather.
        # Plain jnp, so the lane axis shards across a mesh exactly like
        # the dense step: _wrap's shard_map splits hist/x/y on lanes and
        # replicates (taps, starts[, coef]) — streams are share-nothing,
        # zero collectives.
        tile = 2048
        starts_np, phases = _gather_starts(spec, bspec, n_out, tile)
        if spec.fixed_point and not spec.use_direct:
            taps_r, coef_r = spec.interp_rows(phases)
            w_g = (jnp.asarray(taps_r), jnp.asarray(starts_np),
                   jnp.asarray(coef_r.astype(np.int32)))
        else:
            w_g = (jnp.asarray(spec.phase_rows(phases)),
                   jnp.asarray(starts_np))
        # the fixed twin accumulates in wrapping int32 on device —
        # bit-exact in any order
        conv = functools.partial(
            fm.resample_gather_fixed if spec.fixed_point
            else fm.resample_gather, tile=tile)

        def step(hist, x, w):
            X = jnp.concatenate([hist, x[:n_in]], axis=0)
            y = conv(X.T, *w)
            return X[n_in:], y[:, :n_out].T

        return BatchedStep(fn=_wrap(step), w=w_g, hist_rows=N - 1,
                           chunk_rows=n_in, zero_tail=0)

    stride = bspec.stride
    if spec.fixed_point and not spec.use_direct:
        # FIXED interpolated: four explicit accumulator columns per output
        # (the integer cubic mix is nonlinear in the taps), column order
        # c-minor
        comps = [ph.build_padded_weights(spec.interp_taps[:, c, :],
                                         spec.num, spec.den, bspec.f0,
                                         bspec.group) for c in range(4)]
        w_np = np.stack(comps, axis=2).reshape(comps[0].shape[0], -1)
        n_accum = 4
    else:
        w_np = ph.build_padded_weights(spec.phase_table, spec.num, spec.den,
                                       bspec.f0, bspec.group)
        n_accum = 1
    L_pad = -(-w_np.shape[0] // stride) * stride
    if L_pad != w_np.shape[0]:
        w_np = np.pad(w_np, ((0, L_pad - w_np.shape[0]), (0, 0)))
    A = L_pad // stride
    # patch construction reads (A + n_blocks) * stride samples
    T = (bspec.n_blocks + A) * stride
    pad = T - (N - 1 + n_in)
    assert pad >= 0

    if spec.fixed_point:
        # FIXED_POINT universe: exact int8-plane matmul (bit-exact vs the
        # fixed reference — wrapping int32 sums are order-independent, see
        # ops/fir_matmul.resample_conv_tm_fixed)
        w_dev = tuple(jnp.asarray(p) for p in fm.fixed_weight_planes(w_np))
        if n_accum == 4:
            bc = ph.block_constants(spec.num, spec.den, bspec.f0,
                                    bspec.group)
            w_dev += (jnp.asarray(
                spec.interp_coef[bc.p].astype(np.int32)),)  # [R, 4]
        conv = functools.partial(fm.resample_conv_tm_fixed, stride=stride,
                                 n_accum=n_accum)
    else:
        w_dev = jnp.asarray(w_np)
        conv = functools.partial(fm.resample_conv_tm, stride=stride)

    def step(hist, x, w):
        X = jnp.concatenate(
            [hist, x, jnp.zeros((pad, x.shape[1]), dtype=jnp.int16)], axis=0)
        y = conv(X, w)[:n_out]
        return jax.lax.dynamic_slice_in_dim(X, n_in, N - 1, axis=0), y

    return BatchedStep(fn=_wrap(step), w=w_dev, hist_rows=N - 1,
                       chunk_rows=n_in, zero_tail=0)


class _HostFifo:
    """Staging FIFO of time-major [n, B] int16 rows, O(1) amortized per
    push (a deque of chunks + a consume offset into the head).

    Replaces a per-call ``np.concatenate`` that re-copied the WHOLE
    staging buffer on every ``process()`` — the Transform-style cadence of
    many small pushes was quadratic.  Mirrors the reference's
    O(1)-per-chunk staging through the wasm heap (src/index.ts:71-92);
    the native C++ FIFO (speex_tpu_runtime.cpp) does the same for the
    ragged FleetResampler path.
    """

    def __init__(self, B: int):
        self.B = B
        self._parts: collections.deque[np.ndarray] = collections.deque()
        self._off = 0      # consumed rows of the head part
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def push(self, x: np.ndarray, owned: bool = False) -> None:
        """``owned=True`` skips the defensive copy when the caller hands
        over a buffer nothing else aliases (the copy is the same one the
        reference makes into HEAPU8, src/index.ts:92)."""
        if not x.shape[0]:
            return
        if not owned:
            x = x.copy()
        self._parts.append(x)
        self._n += x.shape[0]

    def pop_into(self, out: np.ndarray, n: int) -> None:
        """Consume n rows directly into ``out[:n]`` (one copy, straight
        into the launch slab)."""
        assert self._n >= n, (self._n, n)
        w = 0
        while w < n:
            head = self._parts[0]
            take = min(head.shape[0] - self._off, n - w)
            out[w:w + take] = head[self._off:self._off + take]
            w += take
            self._off += take
            if self._off == head.shape[0]:
                self._parts.popleft()
                self._off = 0
        self._n -= n

    def pop_all(self) -> np.ndarray:
        """Consume everything as one array (cold paths: drain/flush)."""
        out = np.empty((self._n, self.B), dtype=np.int16)
        self.pop_into(out, self._n)
        return out

    def peek_all(self) -> np.ndarray:
        """Snapshot without consuming (checkpointing)."""
        if not self._parts:
            return np.zeros((0, self.B), dtype=np.int16)
        parts = list(self._parts)
        parts[0] = parts[0][self._off:]
        if len(parts) == 1:
            return parts[0].copy()
        return np.concatenate(parts, axis=0)


class BatchedResampler(ZeroFillDegradation):
    """Resample S identical-config streams (C channels each) in lockstep.

    All lanes share (in_rate, out_rate, quality) — heterogeneous fleets are
    bucketed by config, one engine per bucket (SURVEY.md §7 hard part 6).

    Bit-parity contract: each lane's output sequence equals the reference's
    ``speex_resampler_process_int`` output for that lane's sample sequence
    (within the 1-LSB bound), asserted by tests/test_batch.py against the
    single-stream core.

    Parameters
    ----------
    n_streams, channels : lane geometry; B = n_streams * channels.
    target_chunk_frames : desired input frames per lane per launch; rounded
        to the launch quantum (a multiple of ``group*num``).
    mesh / axis : optional ``jax.sharding.Mesh`` and axis name to shard the
        lane axis across devices (B must divide evenly).

    Stride semantics: the C API's in/out stride ints
    (speex_resampler_set_input_stride, resample.c:1170-1188) exist so C
    callers can walk interleaved or padded buffers.  Here the [S, n, C]
    array layout subsumes them — ``process`` accepts ANY NumPy strided view
    (a transposed buffer, every k-th channel of a wider recording, ...),
    which is strictly more general than the C stride ints; the single-
    stream ``ResamplerCore`` keeps the literal stride API for parity.
    """

    def __init__(self, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, quality: int = 7, *,
                 target_chunk_frames: int = 4096,
                 mesh: jax.sharding.Mesh | None = None,
                 axis: str = "streams",
                 fixed_point: bool = False,
                 max_latency_ms: float | None = None):
        if n_streams <= 0 or channels <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if in_rate <= 0 or out_rate <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if max_latency_ms is not None and max_latency_ms <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.n_streams = n_streams
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.fixed_point = bool(fixed_point)
        g = math.gcd(in_rate, out_rate)
        try:
            self.spec = fd.design_filter(in_rate // g, out_rate // g,
                                         quality, fixed_point=fixed_point)
        except fd.OverflowArgError:
            # the C build fails its INT_MAX guards here and init returns
            # RESAMPLER_ERR_OVERFLOW (resample.c:643-656) — surface the
            # same error code, like ResamplerCore._update_filter
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        self.B = n_streams * channels
        self._target = target_chunk_frames
        # hard latency budget: the launch quantum IS the availability
        # latency; a low-latency engine (e.g. the voip preset's 20 ms)
        # caps the quantum, trading GEMM efficiency for responsiveness
        self._max_in = (None if max_latency_ms is None
                        else int(max_latency_ms * in_rate / 1000))
        self._mesh, self._axis = mesh, axis
        if mesh is not None:
            P = jax.sharding.PartitionSpec
            self._lane_sharding = jax.sharding.NamedSharding(
                mesh, P(None, axis))
            self._repl_sharding = jax.sharding.NamedSharding(mesh, P())
        else:
            self._lane_sharding = self._repl_sharding = None
        self._f0 = 0
        # zero-fill degradation (resample.c:561-591, :785-791): a device
        # failure swaps the engine onto a host zero-output step that keeps
        # consuming/producing the exact sample counts, so fleet callers
        # ignoring errors can't deadlock.  Sticky, like the C fn-ptr swap.
        self._degraded = False
        # compiled steps keyed by f0 (mid-stream skip_zeros/flush rebuilds
        # revisit phases; keep a few so repeat switches don't re-trace)
        self._step_cache: dict = {}
        self._build_step(0)
        # time-major: lanes ride the minor axis on device
        self._hist = self._on_lanes(
            jnp.zeros((self._step.hist_rows, self.B), dtype=jnp.int16))
        self._skip = 0
        # staging FIFO of not-yet-launched input frames, [*, B] host int16
        self._staged = _HostFifo(self.B)
        # outputs banked by a partial drain (skip_zeros/flush), surfaced on
        # the next process()/flush()
        self._carry_out: list[np.ndarray] = []

    def _build_step(self, f0: int) -> None:
        """(Re)compile the steady-state step at fractional phase ``f0``.

        The launch quantum (in/out frames) is f0-independent — only the
        phase weights and the chunk-rows padding change — so staging and
        readiness are unaffected.  Rebuilds happen on cold control-path
        operations (mid-stream skip_zeros / flush continuation)."""
        if self._degraded:
            # the zero-output step is phase-weight-free; only the phase
            # counter matters for sample accounting (quantum is
            # f0-independent), and the dead device must not be touched
            self._f0 = f0
            return
        cached = self._step_cache.get(f0)
        if cached is None:
            bspec = _launch_geometry(self.spec, self._target, f0=f0,
                                     max_in_frames=self._max_in)
            step = make_batched_step(self.spec, bspec, mesh=self._mesh,
                                     axis=self._axis)
            w = step.w
            if self._repl_sharding is not None:
                w = jax.device_put(w, self._repl_sharding)
            compile_step(step.fn,
                         self._on_lanes(jnp.zeros(
                             (step.hist_rows, self.B), dtype=jnp.int16)),
                         self._on_lanes(jnp.zeros(
                             (step.chunk_rows, self.B), dtype=jnp.int16)),
                         w)
            # persistent launch slabs, double-buffered: with the depth-1
            # dispatch pipeline in process(), slab i may still be
            # transferring while slab i+1 is filled (see FleetResampler)
            slabs = [np.zeros((step.chunk_rows, self.B), dtype=np.int16)
                     for _ in range(2)]
            cached = (bspec, step, w, slabs)
            if len(self._step_cache) >= 4:
                self._step_cache.pop(next(iter(self._step_cache)))
            self._step_cache[f0] = cached
        self.bspec, self._step, self._w, self._slabs = cached
        self._slab_i = 0
        self._f0 = f0

    # -- geometry --------------------------------------------------------

    @property
    def in_frames_per_launch(self) -> int:
        return self.bspec.in_per_launch

    @property
    def out_frames_per_launch(self) -> int:
        return self.bspec.out_per_launch

    @property
    def launch_latency_ms(self) -> float:
        """Availability latency of the batch quantum: audio staged before
        a launch can run (the streaming Transform analog delivers output
        after at most this much input, src/index.ts:121-162)."""
        return self.bspec.in_per_launch / self.in_rate * 1000.0

    def input_latency(self) -> int:
        return self.spec.input_latency

    def output_latency(self) -> int:
        return self.spec.output_latency

    def _drain_partial(self) -> None:
        """Consume the sub-quantum staged remainder EXACTLY, banking its
        outputs into ``_carry_out`` and advancing the engine phase.

        After feeding s frames, the closed form puts the stream at
        t = f0 + m*num (m = producible outputs): next window origin
        t//den >= s and fractional phase t % den.  The origin surplus
        becomes a pending skip (absorbed from future input); a changed
        fractional phase rebuilds the step with new f0 weights.  The true
        filter history is recomputed host-side from (hist ++ staged), so
        the launch's zero padding never contaminates state and the engine
        can CONTINUE exactly after a drain."""
        s = len(self._staged)
        if s == 0:
            return
        q = self.bspec.in_per_launch
        staged = self._staged.pop_all()
        num, den = self.spec.num, self.spec.den
        m = ph.producible_outputs(s, 0, self._f0, num, den)
        hist_host = self._hist_host()
        chunk = np.zeros((q, self.B), dtype=np.int16)
        chunk[:s] = staged
        _, y = self._launch(chunk)
        if m:
            self._carry_out.append(self._recv(y)[:m])
        hist_np = np.concatenate([hist_host, staged])[s:]
        if self._degraded:
            self._hist = hist_np
        else:
            self._hist = self._on_lanes(jnp.asarray(hist_np))
        t = self._f0 + m * num
        self._skip = t // den - s     # pending origin advance, >= 0
        if t % den != self._f0:
            self._build_step(t % den)

    def skip_zeros(self):
        """Swallow the filter delay (resample.c:1200-1206) — allowed at ANY
        time, like the C API.

        Setting ``last_sample = filt_len//2`` shifts the next window origin
        to k = filt_len//2 ahead of the current stream position.  The
        engine first drains any sub-quantum staged remainder exactly (its
        outputs surface on the next process()/flush()), then realises the
        shift by feeding the next k input frames into the *tail of the
        history* instead of staging them (see ``process``)."""
        self._drain_partial()
        self._skip = self.spec.filt_len // 2

    def reset_mem(self):
        """resample.c:1208-1220.  Note degradation survives a reset, like
        the C core (reset_mem never re-runs update_filter, so the zero
        resampler_ptr installed on failure stays installed)."""
        if self._f0 != 0:
            self._build_step(0)
        if self._degraded:
            self._hist = np.zeros((self._step.hist_rows, self.B),
                                  dtype=np.int16)
        else:
            self._hist = self._on_lanes(
                jnp.zeros((self._step.hist_rows, self.B), dtype=jnp.int16))
        self._staged = _HostFifo(self.B)
        self._skip = 0
        self._carry_out = []

    # -- checkpoint/resume (SURVEY.md §5: the state IS a checkpoint) -------

    def state_dict(self) -> dict:
        return {
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "quality": self.spec.quality,
            "fixed_point": self.fixed_point,
            "n_streams": self.n_streams, "channels": self.channels,
            "hist": self._hist_host(),
            "staged": self._staged.peek_all(),
            "skip": self._skip,
            "f0": self._f0,
            "degraded": self._degraded,
            "carry_out": [o.copy() for o in self._carry_out],
        }

    def load_state_dict(self, state: dict):
        if (state["n_streams"], state["channels"]) != (self.n_streams,
                                                       self.channels) or \
                (state["in_rate"], state["out_rate"], state["quality"]) != \
                (self.in_rate, self.out_rate, self.spec.quality) or \
                state.get("fixed_point", False) != self.fixed_point:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        f0 = int(state.get("f0", 0))
        if state.get("degraded", False):
            self._degraded = True
        if f0 != self._f0:
            self._build_step(f0)
        hist_np = _adapt_hist(state["hist"], self._step.hist_rows,
                              self.spec.filt_len, self.B)
        if self._degraded:
            self._hist = hist_np
        else:
            self._hist = self._on_lanes(jnp.asarray(hist_np))
        self._staged = _HostFifo(self.B)
        self._staged.push(np.array(state["staged"], dtype=np.int16),
                          owned=True)
        self._skip = int(state["skip"])
        self._carry_out = [np.array(o, dtype=np.int16)
                           for o in state.get("carry_out", [])]

    # -- processing ------------------------------------------------------

    def process(self, frames: np.ndarray) -> np.ndarray:
        """frames: int16 [S, n, C] (or time-major lanes [n, B]) → int16
        [S, m, C] (or [m, B]).

        Stages input and runs as many full launches as are available; m is
        a multiple of out_frames_per_launch (possibly 0).  Call flush() at
        end-of-stream to drain the remainder.
        """
        x = self._to_lanes(frames)
        if self._skip:
            # fold the first k frames into the history tail (see skip_zeros)
            k = min(self._skip, x.shape[0])
            if self._degraded:
                self._hist = np.concatenate([self._hist[k:], x[:k]], axis=0)
            else:
                absorbed = self._on_lanes(
                    jnp.asarray(np.ascontiguousarray(x[:k])))
                self._hist = jnp.concatenate([self._hist[k:], absorbed],
                                             axis=0)
            x = x[k:]
            self._skip -= k
        # the 3-D frame layout was already copied by _to_lanes; hand the
        # FIFO ownership so only genuinely-aliasing 2-D views get the
        # defensive copy
        self._staged.push(x, owned=not np.may_share_memory(x, frames))
        outs, self._carry_out = self._carry_out, []
        q = self.bspec.in_per_launch
        pending = None
        while len(self._staged) >= q:
            # depth-1 dispatch pipeline: launch i+1 is dispatched before
            # launch i's result is pulled, overlapping device compute with
            # host readback (dispatch is async; _recv blocks properly)
            slab = self._slabs[self._slab_i]
            self._slab_i ^= 1
            self._staged.pop_into(slab, q)  # straight into the launch slab
            self._hist, y = self._launch(slab)
            if pending is not None:
                outs.append(self._recv(pending))
            pending = y
        if pending is not None:
            outs.append(self._recv(pending))
        if outs:
            return self._from_lanes(np.concatenate(outs, axis=0), frames)
        return self._from_lanes(np.zeros((0, self.B), dtype=np.int16),
                                frames)

    def flush(self) -> np.ndarray:
        """Drain staged frames exactly; returns the outputs whose windows
        start within the real input (plus any outputs banked by an earlier
        skip_zeros drain), in [S, m, C] layout.  Unlike an end-of-stream
        discard, the engine state stays exact: processing may continue."""
        self._drain_partial()
        outs, self._carry_out = self._carry_out, []
        if not outs:
            return np.zeros((self.n_streams, 0, self.channels), np.int16)
        return self._lanes_to_frames(np.concatenate(outs, axis=0))

    # -- zero-fill degradation: shared machinery in utils/degrade.py ------

    def _degraded_launch(self, chunk_np: np.ndarray):
        """Host zero-output launch with exact sample accounting
        (resampler_basic_zero, resample.c:561-591)."""
        return self._advance_degraded_hist(chunk_np), self._zero_result()

    def _launch(self, chunk_np: np.ndarray):
        """Async-dispatch one launch; the result is NOT yet ready — readers
        must go through _recv/to_host (np.asarray on a not-yet-ready array
        can deadlock on some backends)."""
        if self._degraded:
            return self._degraded_launch(chunk_np)
        q = self.bspec.in_per_launch
        if chunk_np.shape[0] == self._step.chunk_rows:
            slab = chunk_np
        else:
            assert chunk_np.shape[0] == q, chunk_np.shape
            slab = self._slabs[self._slab_i]
            self._slab_i ^= 1
            slab[:q] = chunk_np
        try:
            x = self._on_lanes(jnp.asarray(slab))
            return self._step.fn(self._hist, x, self._w)
        except Exception:
            self._enter_degraded()
            return self._degraded_launch(chunk_np)

    # -- layout helpers ---------------------------------------------------
    # lane l = stream*channels + channel; time-major [n, B] on device.

    def _on_lanes(self, a):
        """Place a time-major [n, B] array on the engine's lane sharding
        (identity without a mesh)."""
        if self._lane_sharding is None:
            return a
        return jax.device_put(a, self._lane_sharding)

    def _to_lanes(self, frames: np.ndarray) -> np.ndarray:
        frames = np.asarray(frames, dtype=np.int16)
        if frames.ndim == 2:  # already time-major lanes [n, B]
            if frames.shape[1] != self.B:
                raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
            return frames
        if frames.ndim != 3 or frames.shape[0] != self.n_streams \
                or frames.shape[2] != self.channels:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        # [S, n, C] -> [n, S*C]
        return np.ascontiguousarray(
            frames.transpose(1, 0, 2).reshape(frames.shape[1], self.B))

    def _lanes_to_frames(self, lanes: np.ndarray) -> np.ndarray:
        return lanes.reshape(-1, self.n_streams, self.channels).transpose(
            1, 0, 2)

    def _from_lanes(self, lanes: np.ndarray, like: np.ndarray) -> np.ndarray:
        if np.asarray(like).ndim == 2:
            return lanes
        return self._lanes_to_frames(lanes)
