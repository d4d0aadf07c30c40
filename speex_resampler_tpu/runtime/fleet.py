"""FleetResampler — production serving front-end for many concurrent streams.

Combines the native host runtime (ragged per-stream staging, native.py /
speex_resampler_tpu/native/speex_tpu_runtime.cpp) with the lockstep batched device step
(parallel/batch.py): callers push bytes or frames per stream at their own
cadence; whenever every stream has a full launch quantum staged, ``poll()``
runs device launches and banks per-stream output PCM for ``pull()``.

This is the fleet-scale equivalent of running S independent reference
``SpeexResamplerTransform`` streams (src/index.ts:121-162) — same
per-stream byte-alignment carry, same s16 PCM in/out — with the resampling
itself batched onto one device launch per quantum (the flagship
deployment: 1024 concurrent stereo streams in one launch).
"""

from __future__ import annotations

import collections
import math

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import filter_design as fd
from ..ops import phase as ph
from ..parallel.batch import (_adapt_hist, _launch_geometry, compile_step,
                              make_batched_step)
from ..utils.degrade import ZeroFillDegradation
from ..utils.errors import ResamplerError, ResamplerErrorCode
from .native import make_stager
from ..utils.profiling import LaunchStats

__all__ = ["FleetResampler"]


class FleetResampler(ZeroFillDegradation):
    """S homogeneous streams (same rates/quality), independent cadence."""

    def __init__(self, n_streams: int, channels: int, in_rate: int,
                 out_rate: int, quality: int = 7, *,
                 target_chunk_frames: int = 4096,
                 fixed_point: bool = False,
                 max_latency_ms: float | None = None,
                 max_staged_frames: int | None = None,
                 max_banked_frames: int | None = None,
                 pipeline_depth: int = 2,
                 device_consumer=None):
        """``max_staged_frames`` / ``max_banked_frames`` are per-stream
        high-watermarks bounding host memory (the reference's Node
        Transform inherits stream backpressure, src/index.ts:121-162;
        these are its explicit analog — see docs/serving.md
        "Backpressure").  A push that would exceed the staging watermark
        raises ALLOC_FAILED (callers poll ``writable()`` to pause the
        producer instead); ``poll()`` stops launching while any active
        stream's banked output exceeds the banked watermark, so a
        consumer that never pulls stalls the pipeline instead of growing
        it.  ``None`` (default) = unbounded, the round-3 behavior.

        ``pipeline_depth`` = launches kept in flight before the oldest
        result is pulled back.  Depth 2 (default) overlaps device compute
        AND result readback with the next launch's host gather/dispatch
        (``self.stats`` records the per-phase breakdown).  Depth 1 is the
        classic dispatch-then-drain pipeline.

        ``device_consumer`` — DEVICE-RESIDENT egress: a traceable fn
        ``y i16[out_rows, B] -> small array`` fused into the jitted step
        (the resampled audio feeds a downstream on-chip pipeline — an ASR
        front-end, a mixer — instead of returning to the host).  Readback
        then transfers only the consumer's result (O(1) for a checksum/
        reduction), ``pull()`` yields nothing, and per-launch consumer
        results are appended to ``self.consumed``.  This replaces the
        reference's mandatory WASM-heap copy-out (src/index.ts:111-115)
        with no host egress at all.

        The step is compiled here: a step the device cannot compile
        raises ResamplerError(ALLOC_FAILED) from the constructor rather
        than degrading the engine at its first launch."""
        if n_streams <= 0 or channels <= 0 or in_rate <= 0 or out_rate <= 0:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if (max_staged_frames is not None and max_staged_frames <= 0) or \
                (max_banked_frames is not None and max_banked_frames <= 0):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.n_streams = n_streams
        self.channels = channels
        self.in_rate = in_rate
        self.out_rate = out_rate
        self.fixed_point = bool(fixed_point)
        self.B = n_streams * channels
        self._active = [True] * n_streams
        g = math.gcd(in_rate, out_rate)
        try:
            self.spec = fd.design_filter(in_rate // g, out_rate // g,
                                         quality, fixed_point=fixed_point)
        except fd.OverflowArgError:
            # C's init fails its INT_MAX guards with
            # RESAMPLER_ERR_OVERFLOW (resample.c:643-656); callers (e.g.
            # MultiFleet.set_stream_rate's transactional destination-
            # bucket reservation) rely on ResamplerError, not ValueError
            raise ResamplerError(ResamplerErrorCode.OVERFLOW)
        max_in = (None if max_latency_ms is None
                  else int(max_latency_ms * in_rate / 1000))
        self.bspec = _launch_geometry(self.spec, target_chunk_frames,
                                      max_in_frames=max_in)
        if max_staged_frames is not None \
                and max_staged_frames < self.bspec.in_per_launch:
            # a staging watermark below the launch quantum means lockstep
            # readiness can never be reached — a config error, not a
            # runtime stall
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self.max_staged_frames = max_staged_frames
        self.max_banked_frames = max_banked_frames
        self._banked = [0] * n_streams  # banked output frames per stream
        # lane_major: the step consumes/produces [B, rows] slabs so the
        # host-side gather/scatter stays contiguous per stream (the
        # transposes ride the device inside the jitted step)
        self._step = make_batched_step(self.spec, self.bspec,
                                       lane_major=True)
        self._w = self._step.w
        self._consumer = device_consumer
        self.consumed: list = []  # per-launch device_consumer results
        if device_consumer is not None:
            base_fn = self._step.fn

            def _fused(hist, x, w):
                h2, y = base_fn(hist, x, w)
                return h2, device_consumer(y)

            self._fused_fn = jax.jit(_fused)
        self._hist = jnp.zeros((self._step.hist_rows, self.B),
                               dtype=jnp.int16)
        compile_step(self._fused_fn if device_consumer is not None
                     else self._step.fn, self._hist,
                     jnp.zeros((self.B, self._step.chunk_rows),
                               dtype=jnp.int16), self._w)
        self._stager = make_stager(n_streams, channels,
                                   self.bspec.in_per_launch)
        # persistent launch slabs, depth+1 of them: with D launches in
        # flight, slab i may still be transferring to the device while
        # later slabs are filled; slab i is only refilled AFTER launch i's
        # result has been pulled (D dispatches later), by which point its
        # input transfer has certainly completed.
        #
        # LANE-MAJOR [B, chunk_rows]: the host gather/scatter then runs
        # contiguous per-stream rows (srt_fill_launch_lm/srt_unpack_all_lm)
        # instead of a strided time-major walk; the time-major transpose
        # the step needs rides the device
        # inside the jitted step, where it is HBM-bandwidth trivial.
        # Columns [in_per_launch, chunk_rows) are the step's zero tail —
        # zeroed once here, never touched by the lane-major fill.
        self._depth = max(1, int(pipeline_depth))
        self._slabs = [np.zeros((self.B, self._step.chunk_rows),
                                dtype=np.int16)
                       for _ in range(self._depth + 1)]
        self._slab_i = 0
        self._out: list[list[np.ndarray]] = [[] for _ in range(n_streams)]
        self.stats = LaunchStats()
        # zero-fill degradation (resample.c:561-591, :785-791 analog): a
        # device failure swaps poll() onto a host zero-output dispatch
        # with exact sample accounting.  Sticky, like the C fn-ptr swap.
        self._degraded = False
        self._flushed = False  # flush() is terminal; see its docstring

    # -- ingress ----------------------------------------------------------

    def push(self, stream: int, frames: np.ndarray) -> None:
        """frames: int16 [n, C] interleaved for one stream.

        Raises ALLOC_FAILED when accepting would cross the per-stream
        ``max_staged_frames`` watermark (backpressure; check
        ``writable()`` first to pause the producer instead)."""
        if self._flushed:
            # lane histories hold flush padding; resampling new audio
            # against them would be silently wrong
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self._check_watermark(stream, np.asarray(frames).shape[0])
        self._stager.push(stream, frames)

    def push_bytes(self, stream: int, data: bytes) -> int:
        """Raw s16 PCM bytes; partial frames carry over (Transform-stream
        alignment semantics, src/index.ts:148-154).  Watermark semantics
        as in ``push`` (the check counts whole frames the bytes complete,
        including the pending alignment carry)."""
        if self._flushed:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if self.max_staged_frames is not None:
            fb = self.channels * 2
            n = (self._stager.carry_size(stream) + len(data)) // fb
            self._check_watermark(stream, n)
        return self._stager.push_bytes(stream, data)

    def _check_watermark(self, stream: int, n_frames: int) -> None:
        if self.max_staged_frames is None:
            return
        if self._stager.staged_one(stream) + n_frames \
                > self.max_staged_frames:
            raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)

    def writable(self, stream: int, frames: int = 1) -> bool:
        """Transform-stream pause signal: True iff a push of ``frames``
        whole frames is guaranteed to be accepted (staged + frames stays
        within the watermark).  Producers pushing multi-frame chunks must
        pass their chunk size — the 1-frame default only guards the next
        single frame.  Always True when unbounded."""
        if self._flushed:
            return False  # push() always raises after terminal flush()
        if self.max_staged_frames is None:
            return True
        return (self._stager.staged_one(stream) + frames
                <= self.max_staged_frames)

    def staged(self) -> np.ndarray:
        return self._stager.staged()

    # -- execution --------------------------------------------------------

    def poll(self, max_launches: int | None = None) -> int:
        """Run up to ``max_launches`` ready device launches; returns count.

        Up to ``pipeline_depth`` launches are dispatched before the oldest
        result is pulled back, so device compute and result readback
        overlap the next launch's host gather/dispatch (dispatch is async;
        only _recv blocks).  Every phase's wall-clock is attributed in
        ``self.stats`` (gather / dispatch / readback / unpack) — the
        serving pipeline's cost structure.

        With ``max_banked_frames`` set, launching PAUSES while any active
        stream's banked output sits at/over the watermark — the consumer
        must pull before more output is produced (bounded memory under a
        never-pulling consumer; staging then backs up to ITS watermark
        and pushes start raising)."""
        n = self._stager.ready_launches()
        if max_launches is not None:
            n = min(n, max_launches)
        pending: collections.deque = collections.deque()
        ran = 0
        for _ in range(n):
            if self._output_paused():
                break
            slab = self._slabs[self._slab_i]
            self._slab_i = (self._slab_i + 1) % len(self._slabs)
            with self.stats.phase("gather"):
                self._stager.fill_launch_lm(slab)
            pending.append(self._dispatch(slab))
            ran += 1
            if len(pending) >= self._depth:
                self._drain_one(pending)
        while pending:
            self._drain_one(pending)
        return ran

    def _drain_one(self, pending) -> None:
        with self.stats.phase("readback"):
            y = self._recv(pending.popleft())
        if self._consumer is not None:
            # device-resident egress: y IS the consumer's result; nothing
            # to unpack or bank (audio never crossed to the host)
            self.consumed.append(y)
            return
        with self.stats.phase("unpack"):
            self._bank(y, None)

    def _output_paused(self) -> bool:
        if self.max_banked_frames is None:
            return False
        return any(b >= self.max_banked_frames
                   for b, a in zip(self._banked, self._active) if a)

    def flush(self) -> None:
        """END-OF-STREAM drain: process ALL staged frames (zero-padding
        each stream's final partial quantum) and bank only the outputs
        whose windows start within real input.

        Terminal: the padding zeros advance lane filter histories, and
        streams whose staged counts differ leave lanes phase-divergent —
        neither is representable by the lockstep engine, so further
        ``push`` raises.  For exact continuation semantics use
        ``BatchedResampler.flush`` (lockstep streams) or hand the lane off
        through ``MultiFleet`` (per-stream sub-quantum drains)."""
        self.poll()
        # fill_flush caps each stream at one quantum per call; loop so a
        # stream with >1 quantum staged (possible when lockstep readiness
        # was gated by an emptier stream) drains completely.  Outputs keep
        # composing because the quantum consumes a multiple of num inputs
        # (phase returns to f0 at every launch boundary).
        while True:
            slab, staged = self._stager.fill_flush()
            if slab is None:
                break
            y = self._recv(self._dispatch_chunk(slab))
            if self._consumer is not None:
                # device-resident egress: the final partial quantum is
                # consumed on device too (its zero-padding tail windows
                # included — the consumer sees the same don't-care rows
                # the banking path would have trimmed)
                self.consumed.append(y)
                continue
            per_stream = [ph.producible_outputs(int(f), 0, self.bspec.f0,
                                                self.spec.num, self.spec.den)
                          for f in staged]
            self._bank(y, per_stream)
        self._flushed = True

    # -- zero-fill degradation: shared machinery in utils/degrade.py ------

    def _degraded_dispatch(self, slab: np.ndarray):
        """Zero-output launch: consume q rows, emit n_out zero rows,
        advance history identically to the healthy step."""
        self._hist = self._advance_degraded_hist(slab)
        return self._zero_result()

    def _dispatch(self, slab: np.ndarray):
        """Async-dispatch one launch on a fully prepared LANE-MAJOR slab
        ([B, chunk_rows]; the jitted step transposes on device)."""
        with self.stats.launch(self.bspec.in_per_launch * self.B,
                               self.bspec.out_per_launch * self.B), \
                self.stats.phase("dispatch"):
            if self._degraded:
                return self._degraded_dispatch(slab)
            try:
                x = jnp.asarray(slab)
                fn = (self._fused_fn if self._consumer is not None
                      else self._step.fn)
                self._hist, y = fn(self._hist, x, self._w)
                return y
            except Exception:
                self._enter_degraded()
                return self._degraded_dispatch(slab)

    def _dispatch_chunk(self, chunk: np.ndarray):
        """Dispatch from a bare time-major [n_in, B] chunk (the flush
        slab — a terminal one-shot path, so the host transpose into the
        lane-major launch slab is paid once per stream lifetime)."""
        q = self.bspec.in_per_launch
        slab = self._slabs[self._slab_i]
        self._slab_i = (self._slab_i + 1) % len(self._slabs)
        slab[:, :q] = chunk.T
        return self._dispatch(slab)

    # -- lane-major degradation overrides (base class is time-major) -------

    def _zero_result(self) -> np.ndarray:
        return np.zeros((self.B, self.bspec.out_per_launch),
                        dtype=np.int16)

    def _advance_degraded_hist(self, slab: np.ndarray) -> np.ndarray:
        q = self.bspec.in_per_launch
        H = self._step.hist_rows
        return np.concatenate([self._hist, np.asarray(slab[:, :q]).T],
                              axis=0)[-H:]

    def _bank(self, y: np.ndarray, per_stream) -> None:
        outs = self._stager.unpack_all_lm(y)  # [S, n_out, C]
        for s in range(self.n_streams):
            if not self._active[s]:
                # inactive lanes are zero-filled in slabs but their stale
                # history still convolves to nonzero rows — never bank them
                continue
            o = outs[s]
            if per_stream is not None:
                o = o[:per_stream[s]]
            if o.shape[0]:
                self._out[s].append(o)
                self._banked[s] += o.shape[0]

    # -- slot management (used by MultiFleet for dynamic occupancy) --------

    def set_slot_active(self, slot: int, active: bool) -> None:
        """Inactive slots are excluded from lockstep readiness and
        zero-filled in launch slabs."""
        self._stager.set_active(slot, active)
        self._active[slot] = bool(active)

    def clear_slot(self, slot: int) -> None:
        """Reset one lane for reuse: zero filter history, drop banked
        output (staging is cleared by deactivation)."""
        c = self.channels
        lane = slot * c
        if self._degraded:
            self._hist[:, lane:lane + c] = 0
        else:
            self._hist = self._hist.at[:, lane:lane + c].set(jnp.int16(0))
        self._out[slot] = []
        self._banked[slot] = 0

    def seed_lane_history(self, slot: int, hist: np.ndarray) -> None:
        """Adopt filter memory for one lane (inverse of lane_history):
        hist [filt_len-1, C] becomes the lane's trailing history rows; the
        extra alignment rows in front are never read by the kernels (the
        earliest window starts at row hist_rows-(filt_len-1))."""
        c = self.channels
        N = self.spec.filt_len
        hist = np.asarray(hist, dtype=np.int16)
        if hist.shape != (N - 1, c):
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        H = self._step.hist_rows
        buf = np.zeros((H, c), dtype=np.int16)
        buf[H - (N - 1):] = hist
        lane = slot * c
        if self._degraded:
            self._hist[:, lane:lane + c] = buf
        else:
            self._hist = self._hist.at[:, lane:lane + c].set(
                jnp.asarray(buf))

    def lane_history(self, slot: int) -> np.ndarray:
        """One lane's filter history, [hist_rows, C] — valid for hand-off
        to ResamplerCore.import_history at launch-quantum boundaries (the
        trailing filt_len-1 rows are the actual filter memory)."""
        c = self.channels
        h = self._hist_host()[:, slot * c:(slot + 1) * c]
        N = self.spec.filt_len
        return h[h.shape[0] - (N - 1):]

    def peek_staged(self, slot: int) -> np.ndarray:
        return self._stager.peek(slot)

    def lane_carry(self, slot: int) -> bytes:
        """One lane's byte-alignment carry (a pending partial frame from
        push_bytes) — must be salvaged before deactivating the slot."""
        return self._stager.carry(slot)

    # -- checkpoint/resume (SURVEY.md §5) -----------------------------------

    def state_dict(self) -> dict:
        """Full serializable snapshot: device filter history, per-stream
        staged input (and alignment-carry bytes), banked output."""
        return {
            "n_streams": self.n_streams, "channels": self.channels,
            "in_rate": self.in_rate, "out_rate": self.out_rate,
            "quality": self.spec.quality,
            "fixed_point": self.fixed_point,
            "active": list(self._active),
            "degraded": self._degraded,
            "flushed": self._flushed,
            "hist": self._hist_host(),
            "staged": [self._stager.peek(s) for s in range(self.n_streams)],
            "carry": [self._stager.carry(s) for s in range(self.n_streams)],
            "banked": [[o.copy() for o in self._out[s]]
                       for s in range(self.n_streams)],
        }

    def load_state_dict(self, state: dict):
        if (state["n_streams"], state["channels"]) != (self.n_streams,
                                                       self.channels) or \
                (state["in_rate"], state["out_rate"], state["quality"]) != \
                (self.in_rate, self.out_rate, self.spec.quality) or \
                state.get("fixed_point", False) != self.fixed_point:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if state.get("degraded", False):
            self._degraded = True
        self._flushed = bool(state.get("flushed", False))
        hist_np = _adapt_hist(state["hist"], self._step.hist_rows,
                              self.spec.filt_len, self.B)
        if self._degraded:
            # sticky: a healthy checkpoint loaded into a degraded engine
            # must keep the host-ndarray hist (the device may be dead)
            self._hist = hist_np
        else:
            self._hist = jnp.asarray(hist_np)
        self._stager = make_stager(self.n_streams, self.channels,
                                   self.bspec.in_per_launch)
        # restore occupancy before staging (deactivation clears staging)
        for s, a in enumerate(state["active"]):
            self.set_slot_active(s, bool(a))
        for s in range(self.n_streams):
            if len(state["staged"][s]):
                self._stager.push(s, state["staged"][s])
            if state["carry"][s]:
                self._stager.push_bytes(s, state["carry"][s])
        self._out = [[np.array(o) for o in outs]
                     for outs in state["banked"]]
        self._banked = [sum(o.shape[0] for o in outs)
                        for outs in self._out]

    # -- egress -----------------------------------------------------------

    @property
    def launch_latency_ms(self) -> float:
        """Availability latency of the lockstep quantum (audio a stream
        must stage before its next launch can run)."""
        return self.bspec.in_per_launch / self.in_rate * 1000.0

    def pending(self, stream: int) -> int:
        return sum(o.shape[0] for o in self._out[stream])

    def pull(self, stream: int) -> np.ndarray:
        """Drain banked output for one stream: int16 [n, C]."""
        outs = self._out[stream]
        self._out[stream] = []
        self._banked[stream] = 0
        if not outs:
            return np.zeros((0, self.channels), dtype=np.int16)
        return np.concatenate(outs, axis=0)

    def pull_bytes(self, stream: int) -> bytes:
        return self.pull(stream).astype("<i2").tobytes()
