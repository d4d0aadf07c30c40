"""MultiFleet — heterogeneous serving: many streams, many configs.

Streams are bucketed by (in_rate, out_rate, quality) — SURVEY.md §7 hard
part 6 — with one lockstep ``FleetResampler`` per bucket and dynamic slot
occupancy (inactive slots are zero-filled by the native stager and excluded
from readiness).  Streams attach and detach at any time:

    mf = MultiFleet(channels=2, capacity_per_bucket=256)
    mf.add_stream("a", 44100, 48000, 7)
    mf.add_stream("b", 8000, 16000, 5)
    mf.push_bytes("a", pcm); mf.poll(); out = mf.pull_bytes("a")
    mf.end_stream("a")          # graceful drain; pull the tail, slot freed

Rate/quality changes mid-stream are EXACT (``set_stream_rate``): the
lane's filter memory migrates across the switch with the C magic-sample
semantics (resample.c:727-782) via a ResamplerCore hand-off, and a short
``_Transition`` serves the stream host-side until its fractional phase
returns to 0 (at most den-1 outputs), at which point the lane re-seeds in
the new config's bucket and batched serving resumes.  A lockstep bucket
cannot host per-stream divergent phase, which is why the transition is
per-stream and bounded rather than batched.

Per-stream exactness: a stream that pushed ``n`` real frames ever gets
exactly ``producible_outputs(n)`` output frames (the reference's one-shot
count) — full quanta run on the batched device engine; the sub-quantum tail
at ``end_stream`` drains through a single-stream core seeded with the
lane's filter history, which is state-faithful because lanes sit at
``last_sample = samp_frac_num = 0`` on every quantum boundary.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.resampler import ResamplerCore
from ..utils.errors import ResamplerError, ResamplerErrorCode
from .fleet import FleetResampler

__all__ = ["MultiFleet"]


_BIG = 10 ** 9


class _Transition:
    """Serves one stream through a ResamplerCore between the moment of a
    rate/quality switch (filter state carried via magic-sample migration,
    resample.c:727-782) and the first instant the stream is lockstep-
    representable again: fractional phase 0, magic drained or staged, and
    the pending window origin absorbed into history.

    The phase returns to 0 after at most den-1 outputs (num and den are
    coprime, so k0 = -frac * num^{-1} mod den); the output capacity
    argument forces the core to stop EXACTLY there, and C's consumption
    clamp (consumed = min(in_len, last_sample), resample.c:891-894) has a
    closed form, so frames the core saw but did not consume are retained
    here and re-fed later — nothing is dropped.
    """

    def __init__(self, core, channels: int):
        self.core = core
        self.C = channels
        self.buf = np.zeros((0, channels), dtype=np.int16)
        self.fed = False          # any user frames since the switch?
        self.done = False
        self.hist = None          # [filt_len-1, C] int16 once done
        self.staged_rest = None   # [n, C] int16 once done

    def feed(self, frames: np.ndarray) -> list[np.ndarray]:
        self.fed = True
        self.buf = np.concatenate([self.buf, frames])
        return self.pump()

    def finish(self) -> list[np.ndarray]:
        """End-of-stream: drain everything through the core exactly.

        Through the NATIVE layer, not a public entry point: the staging
        entry (float build's process_int) processes nothing — not even
        pending magic samples — when ``buf`` is empty, which would strand
        the magic tail past a chained rate switch."""
        out = self.core.process_native_interleaved(self.buf, _BIG)
        self.buf = np.zeros((0, self.C), dtype=np.int16)
        self.done = True
        self.hist = self.staged_rest = None
        return [out] if out.shape[0] else []

    def pump(self, emit: bool = True) -> list[np.ndarray]:
        """Drive the transition.  ``emit=False`` (switch time) only
        attempts the no-output completion repack: C produces NOTHING at a
        set_rate — outputs (including the magic-sample drain) appear only
        at the next process call, so spontaneous emission here would
        diverge from a reference core driven through the same
        push/switch sequence whenever ANOTHER switch chains before data
        flows (the stash must instead migrate through update_filter,
        resample.c:727-782).  For the same reason completion requires the
        magic stash to be fully drained: re-staging stashed samples as
        lockstep input is exact under a fixed filter but makes a later
        chained switch process them under the intermediate config."""
        outs = []
        from ..ops import phase as ph
        while not self.done:
            c = self.core
            num, den = c.num, c.den
            f = int(c.samp_frac_num[0])
            ls = int(c.last_sample[0])
            m_cnt = int(c.magic_samples[0])
            if f == 0 and m_cnt == 0:
                # absorb the window origin into history, stage the rest
                stream = self.buf
                if stream.shape[0] < ls:
                    break  # need more input to cover the origin jump
                N = c.filt_len
                hist = np.rint(np.stack([c._history[ch]
                                         for ch in range(self.C)],
                                        axis=1)).astype(np.int16)
                hist = np.concatenate([hist, stream[:ls]])[ls:]
                assert hist.shape == (N - 1, self.C)
                self.hist = hist
                self.staged_rest = stream[ls:]
                self.buf = np.zeros((0, self.C), dtype=np.int16)
                self.done = True
                break
            if not emit:
                break
            # at phase 0 with magic still stashed, run to the NEXT phase-0
            # boundary (den outputs) so the stash keeps draining
            k0 = (den if f == 0
                  else (-f * pow(num % den, -1, den)) % den)
            virtual_avail = m_cnt + self.buf.shape[0]
            producible = ph.producible_outputs(virtual_avail, ls, f, num,
                                               den)
            m_out = min(k0, producible)
            if m_out == 0:
                break  # need more input
            # enough virtual input to emit m_out outputs (window starts
            # strictly below in_len), may exceed what the core consumes
            origin_last = ls + (f + (m_out - 1) * num) // den
            n_give = max(0, origin_last + 1 - m_cnt)
            # NATIVE layer: the staging entry would process nothing when
            # n_give == 0 (magic alone covers the windows), and its
            # capacity-bound bite quantization would break the closed-form
            # consumed_virtual below; native consumption composes exactly.
            y = c.process_native_interleaved(self.buf[:n_give], m_out)
            assert y.shape[0] == m_out, (y.shape, m_out)
            outs.append(y)
            consumed_virtual = min(n_give + m_cnt,
                                   ls + (f + m_out * num) // den)
            self.buf = self.buf[max(0, consumed_virtual - m_cnt):]
        return outs


@dataclasses.dataclass
class _Stream:
    key: tuple
    slot: int | None        # None once the bucket slot has been freed
    real_frames: int = 0    # real (non-padding) frames pushed
    pulled: int = 0         # output frames already handed to the caller
    ended: bool = False
    byte_carry: bytes = b""  # pending partial-frame bytes (push_bytes)
    carryover: np.ndarray | None = None  # output owed after slot release
    transition: "_Transition | None" = None  # live rate-switch hand-off


class _Bucket:
    def __init__(self, fleet: FleetResampler):
        self.fleet = fleet
        self.free = list(range(fleet.n_streams - 1, -1, -1))
        for slot in range(fleet.n_streams):
            self.fleet.set_slot_active(slot, False)

    @property
    def occupied(self) -> int:
        return self.fleet.n_streams - len(self.free)


class MultiFleet:
    def __init__(self, channels: int, *, capacity_per_bucket: int = 256,
                 target_chunk_frames: int = 4096,
                 fixed_point: bool = False,
                 max_latency_ms: float | None = None,
                 max_staged_frames: int | None = None,
                 max_banked_frames: int | None = None,
                 pipeline_depth: int = 2,
                 max_idle_buckets: int | None = 8):
        """``max_staged_frames`` / ``max_banked_frames`` bound per-stream
        host memory in every bucket (see FleetResampler's backpressure
        contract / docs/serving.md).  The watermarks also bound a
        stream's rate-switch ``carryover`` buffer: a push while carryover
        is at/over ``max_banked_frames`` raises ALLOC_FAILED until the
        caller pulls, and a single mid-transition chunk larger than
        ``max_staged_frames`` is refused exactly as the lockstep path
        would refuse it, so carryover never exceeds
        ``max_banked_frames + ceil(max_staged_frames * out/in)`` plus the
        transition's ≤den-1-output tail.

        ``max_idle_buckets`` bounds bucket memory under config churn: a
        bucket whose last stream detaches goes on an LRU idle list, and
        the oldest idle buckets (compiled engine + weight tables + native
        stager) are released beyond the cap.  A config that returns later
        transparently rebuilds its bucket (one engine-construction cost).
        ``None`` keeps every bucket forever (the pre-knob behavior)."""
        self.channels = channels
        self.capacity = capacity_per_bucket
        self._target = target_chunk_frames
        self._max_latency_ms = max_latency_ms
        self.fixed_point = bool(fixed_point)
        self.max_staged_frames = max_staged_frames
        self.max_banked_frames = max_banked_frames
        self._pipeline_depth = pipeline_depth
        self.max_idle_buckets = max_idle_buckets
        self._buckets: dict[tuple, _Bucket] = {}
        # insertion-ordered LRU of keys whose bucket is fully unoccupied
        self._idle: dict[tuple, None] = {}
        # keys a caller currently holds a _Bucket reference to (e.g. the
        # rate-switch destination between reservation and seeding): the
        # eviction sweep must never drop these even when momentarily empty
        self._pinned: set[tuple] = set()
        self._streams: dict[object, _Stream] = {}

    def _new_fleet(self, in_rate: int, out_rate: int,
                   quality: int) -> FleetResampler:
        """One bucket engine with this MultiFleet's shared knobs."""
        return FleetResampler(
            self.capacity, self.channels, in_rate, out_rate, quality,
            target_chunk_frames=self._target,
            fixed_point=self.fixed_point,
            max_latency_ms=self._max_latency_ms,
            max_staged_frames=self.max_staged_frames,
            max_banked_frames=self.max_banked_frames,
            pipeline_depth=self._pipeline_depth)

    def _bucket_for(self, key: tuple) -> _Bucket:
        """Get-or-create the bucket for a config key (an LRU-evicted idle
        bucket transparently rebuilds here).  Pins the key off the idle
        list: the caller is about to occupy it, and an eviction sweep
        must never drop a bucket a caller holds a reference to."""
        self._idle.pop(key, None)
        b = self._buckets.get(key)
        if b is None:
            b = _Bucket(self._new_fleet(*key))
            self._buckets[key] = b
        return b

    def _note_slot_released(self, key: tuple) -> None:
        """Track empty buckets; release the oldest past max_idle_buckets
        (an empty bucket owes nothing — ended streams' tails live on the
        _Stream records, never in the bucket)."""
        b = self._buckets.get(key)
        if b is None or b.occupied:
            return
        self._idle.pop(key, None)
        self._idle[key] = None
        self._evict_idle()

    def _evict_idle(self) -> None:
        """Release the oldest idle buckets past ``max_idle_buckets``.
        Skips pinned keys (a caller holds the bucket mid-operation — e.g.
        a same-key rate switch whose _drop_slot momentarily empties the
        destination it is about to re-occupy) and drops stale entries
        whose bucket was re-occupied without passing through _bucket_for
        instead of deleting a live bucket."""
        if self.max_idle_buckets is None:
            return
        for k in list(self._idle):
            if len(self._idle) <= self.max_idle_buckets:
                break
            if k in self._pinned:
                continue
            del self._idle[k]
            b = self._buckets.get(k)
            if b is not None and not b.occupied:
                del self._buckets[k]

    # -- stream lifecycle --------------------------------------------------

    def add_stream(self, sid, in_rate: int, out_rate: int, quality: int = 7):
        if sid in self._streams:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        key = (in_rate, out_rate, quality)
        b = self._bucket_for(key)
        if not b.free:
            raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)
        slot = b.free.pop()
        b.fleet.set_slot_active(slot, True)
        b.fleet.clear_slot(slot)
        self._streams[sid] = _Stream(key=key, slot=slot)
        return sid

    def end_stream(self, sid):
        """Graceful end, effective immediately: any staged tail that has
        not reached a launch quantum is drained EXACTLY through a
        single-stream core seeded with the lane's filter history (the lane
        sits at last_sample = samp_frac_num = 0 at quantum boundaries, so
        the hand-off is state-faithful).  The slot frees at once and never
        gates its bucket."""
        st = self._stream(sid)
        if st.ended:
            return
        st.ended = True
        if st.transition is not None:
            for y in st.transition.finish():
                self._add_carryover(st, y)
            st.transition = None
            # the reserved slot was never activated; just release it
            self._buckets[st.key].free.append(st.slot)
            st.slot = None
            self._note_slot_released(st.key)
            return
        if st.slot is None:
            return
        b = self._buckets[st.key]
        fleet = b.fleet
        C = self.channels
        tail_in = fleet.peek_staged(st.slot)
        banked = fleet.pull(st.slot)
        parts = [banked] if len(banked) else []
        if len(tail_in):
            hist = fleet.lane_history(st.slot)
            ir, orr, q = st.key
            core = ResamplerCore(C, ir, orr, ir, orr, q,
                                 fixed_point=self.fixed_point)
            core.import_history(hist)
            parts.append(core.process_interleaved(tail_in, _BIG))
        if parts:
            self._add_carryover(st, np.concatenate(parts))
        self._drop_slot(st)
        # NOT _gc'd here even when nothing is owed: the entry must survive
        # until the caller's post-end pull (the documented sequence), which
        # collects the tail — or an empty array — and then collects the
        # stream record itself.

    def remove_stream(self, sid):
        """Immediate detach: staged input is dropped; already-banked output
        stays pullable until collected."""
        st = self._stream(sid)
        st.ended = True
        st.transition = None          # staged/buffered input is dropped
        if st.slot is not None:
            banked = self._buckets[st.key].fleet.pull(st.slot)
            if len(banked):
                self._add_carryover(st, banked)
            self._drop_slot(st)

    def set_stream_rate(self, sid, in_rate: int, out_rate: int,
                        quality: int | None = None):
        """EXACT mid-stream reconfiguration with filter-state carry — the
        C semantics (speex_resampler_set_rate + set_quality on a live
        state, resample.c:1107-1145, :727-782 magic migration).

        The lane's filter memory hands off to a ResamplerCore at the
        current position (state-faithful: lanes sit at last_sample =
        samp_frac_num = 0 between launches); the staged remainder drains
        under the OLD config, set_rate/set_quality migrate the state, and
        a _Transition serves the stream through the core until its
        fractional phase returns to 0 (at most den-1 outputs), whereupon
        the lane re-seeds in the new bucket and batching resumes."""
        st = self._stream(sid)
        if st.ended:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if quality is None:
            quality = st.key[2]
        new_key = (in_rate, out_rate, quality)
        # Reserve the destination slot BEFORE tearing the old lane down: a
        # full target bucket must fail up front, not after the drain.
        b_new = self._bucket_for(new_key)
        frees_own = (new_key == st.key and st.slot is not None)
        if not b_new.free and not frees_own:
            raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)

        self._pinned.add(new_key)
        try:
            C = self.channels
            if st.transition is not None:
                # switching again mid-transition: frames the transition
                # retained (awaiting its phase-0 boundary) were pushed under
                # the OLD config and must be processed under it BEFORE the
                # core chains set_rate — dropping or deferring them past the
                # switch would diverge from a reference core driven through
                # the same push/switch sequence.  But if NOTHING was fed
                # since the switch, C ran no process call under the old
                # config: the magic stash must stay stashed and migrate
                # through the chained set_rate (update_filter's grow path
                # unpacks it, resample.c:727-765) — force-draining it here
                # would emit it under the intermediate config (found by the
                # watermark churn fuzz, seed 2024).
                if st.transition.fed:
                    for y in st.transition.finish():
                        self._add_carryover(st, y)
                core = st.transition.core
                # release the previously reserved (still inactive) slot
                ob = self._buckets[st.key]
                ob.free.append(st.slot)
                st.slot = None
                self._note_slot_released(st.key)
            else:
                b_old = self._buckets[st.key]
                fleet = b_old.fleet
                banked = fleet.pull(st.slot)
                tail_in = fleet.peek_staged(st.slot)
                # salvage the byte-alignment carry before deactivation clears
                # it; it prefixes whatever push_bytes delivers next
                st.byte_carry = (fleet.lane_carry(st.slot)
                                  + st.byte_carry)
                hist = fleet.lane_history(st.slot)
                ir0, or0, q0 = st.key
                core = ResamplerCore(C, ir0, or0, ir0, or0, q0,
                                     fixed_point=self.fixed_point)
                if st.real_frames > 0:
                    core.import_history(hist)
                # else: virgin stream (nothing ever pushed) — the equivalent C
                # state is UNSTARTED, and set_rate on an unstarted state takes
                # update_filter's fresh path (resample.c:721-726): no magic
                # migration, no history shift.  import_history would force
                # started=1 and emit ~filt_len/2 spurious magic-drain outputs.
                parts = [banked] if len(banked) else []
                if len(tail_in):
                    parts.append(core.process_interleaved(tail_in, _BIG))
                if parts:
                    self._add_carryover(st, np.concatenate(parts))
                # free the old slot, then take the new one
                self._drop_slot(st)

            # The reference CAN reject a switch (multiply_frac's uint32 guard
            # rescaling samp_frac_num, update_filter's INT_MAX guards —
            # resample.c:593-603, :1134).  The lane is already torn down by
            # now, so on rejection restore the pre-switch core and keep
            # serving the stream under its OLD config through a transition
            # (phase may be nonzero, so it cannot re-seed a lockstep lane
            # directly), then surface the error like C's return code.
            snap = core.state_dict()
            try:
                core.set_rate(in_rate, out_rate)
                core.set_quality(quality)
            except ResamplerError:
                ir0, or0, q0 = st.key
                core = ResamplerCore(C, ir0, or0, ir0, or0, q0,
                                     fixed_point=self.fixed_point)
                core.load_state_dict(snap)
                # _bucket_for: the old bucket may have been LRU-released when
                # this (sole) stream's lane was torn down above
                st.slot = self._bucket_for(st.key).free.pop()
                st.transition = _Transition(core, C)
                for y in st.transition.pump(emit=False):
                    self._add_carryover(st, y)
                if st.transition.done:
                    self._seed_from_transition(st)
                # the reserved-then-unused new bucket may now be empty
                self._note_slot_released(new_key)
                raise
            st.key = new_key
            st.slot = b_new.free.pop()      # reserved; inactive until seeded
            st.transition = _Transition(core, C)
            for y in st.transition.pump(emit=False):  # may complete (clean
                self._add_carryover(st, y)            # boundary, no magic)
            if st.transition.done:
                self._seed_from_transition(st)
            return sid
        finally:
            # unpin, then sweep: evictions the pin deferred
            # (including new_key itself if the switch was
            # rejected and the bucket stayed empty) happen now
            self._pinned.discard(new_key)
            self._evict_idle()

    def _add_carryover(self, st: _Stream, out: np.ndarray) -> None:
        if out is None or not len(out):
            return
        st.carryover = (np.concatenate([st.carryover, out])
                        if st.carryover is not None and len(st.carryover)
                        else out)

    def _seed_from_transition(self, st: _Stream) -> None:
        tr = st.transition
        st.transition = None
        b = self._buckets[st.key]
        b.fleet.set_slot_active(st.slot, True)
        b.fleet.clear_slot(st.slot)
        b.fleet.seed_lane_history(st.slot, tr.hist)
        # Internal re-staging of frames the caller ALREADY handed over
        # (retained-unconsumed input + byte-alignment carry) must bypass
        # the staging watermark: raising here would unwind push() after
        # the transition object was discarded, silently dropping the
        # frames.  Accepted input is never re-subjected to backpressure.
        if tr.staged_rest is not None and tr.staged_rest.shape[0]:
            b.fleet._stager.push(st.slot, tr.staged_rest)
        carry = st.byte_carry
        if carry:
            b.fleet._stager.push_bytes(st.slot, carry)
            st.byte_carry = b""

    # -- dataflow ------------------------------------------------------------

    def writable(self, sid, frames: int = 1) -> bool:
        """Transform-stream pause signal (see FleetResampler.writable —
        pass the intended chunk size in ``frames``); mid-transition it
        reflects the carryover bound and the per-chunk staging bound."""
        st = self._stream(sid)
        if st.ended:
            return False
        if st.transition is not None or st.slot is None:
            if (self.max_staged_frames is not None
                    and frames > self.max_staged_frames):
                return False
            return not self._carryover_full(st)
        return self._buckets[st.key].fleet.writable(st.slot, frames)

    def _carryover_full(self, st: _Stream) -> bool:
        return (self.max_banked_frames is not None
                and st.carryover is not None
                and len(st.carryover) >= self.max_banked_frames)

    def push(self, sid, frames: np.ndarray) -> None:
        st = self._stream(sid)
        if st.ended:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        frames = np.asarray(frames, dtype=np.int16)
        if st.transition is not None:
            # a transition banks straight into carryover, bypassing the
            # bucket.  Two watermarks bound it: the banked watermark on
            # the output side (pre-checked — a push while carryover is at
            # the watermark raises), and the staging watermark on the
            # input side (a chunk the lockstep path would have refused as
            # over-watermark is refused here too).  Together they bound
            # carryover by max_banked + ceil(max_staged * out/in) + the
            # transition's own ≤den-1-output tail, a configuration-derived
            # constant (docs/serving.md "Backpressure").
            if self._carryover_full(st):
                raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)
            if (self.max_staged_frames is not None
                    and frames.shape[0] > self.max_staged_frames):
                raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)
            for y in st.transition.feed(frames):
                self._add_carryover(st, y)
            if st.transition.done:
                self._seed_from_transition(st)
            st.real_frames += frames.shape[0]
            return
        b = self._buckets[st.key]
        b.fleet.push(st.slot, frames)
        st.real_frames += frames.shape[0]

    def push_bytes(self, sid, data: bytes) -> int:
        st = self._stream(sid)
        if st.ended:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        if st.transition is not None:
            # frame-align here (the stager's carry is bypassed mid-switch)
            carry = st.byte_carry + data
            fb = self.channels * 2
            keep = len(carry) - len(carry) % fb
            frames = np.frombuffer(carry[:keep], dtype="<i2").reshape(
                -1, self.channels)
            # Apply push()'s refusal checks BEFORE mutating the byte
            # carry: a refused push must change nothing, or the aligned
            # bytes are silently dropped and the carry corrupted.  The
            # carry commit must still precede push() — completing the
            # transition re-stages st.byte_carry, which by then must hold
            # only the sub-frame remainder.
            if self._carryover_full(st):
                raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)
            if (self.max_staged_frames is not None
                    and frames.shape[0] > self.max_staged_frames):
                raise ResamplerError(ResamplerErrorCode.ALLOC_FAILED)
            st.byte_carry = carry[keep:]
            self.push(sid, frames)
            return frames.shape[0]
        n = self._buckets[st.key].fleet.push_bytes(st.slot, data)
        st.real_frames += n
        return n

    def poll(self) -> int:
        total = 0
        for b in self._buckets.values():
            total += b.fleet.poll()
        return total

    def pull(self, sid) -> np.ndarray:
        st = self._stream(sid)
        parts = []
        if st.carryover is not None and len(st.carryover):
            parts.append(st.carryover)
        st.carryover = None
        # during a transition the reserved slot is inactive and owns no
        # banked output (the fleet never banks inactive lanes either)
        if st.slot is not None and st.transition is None:
            got = self._collect(sid)
            if len(got):
                parts.append(got)
        out = (np.concatenate(parts) if parts
               else np.zeros((0, self.channels), dtype=np.int16))
        self._gc(sid)
        return out

    def pull_bytes(self, sid) -> bytes:
        return self.pull(sid).astype("<i2").tobytes()

    def flush(self) -> None:
        """End-of-world drain of every bucket."""
        for sid in list(self._streams):
            if not self._streams[sid].ended:
                self.end_stream(sid)
        self.poll()

    def stats(self) -> dict:
        return {str(k): b.fleet.stats.as_dict()
                for k, b in self._buckets.items()}

    def reset_stats(self) -> None:
        """Zero every bucket's launch/phase counters — e.g. after a
        warmup poll, so steady-state serving stats exclude compile time."""
        for b in self._buckets.values():
            b.fleet.stats = type(b.fleet.stats)()

    @property
    def degraded(self) -> bool:
        """True if ANY bucket's fleet has degraded to the zero-output
        path (see FleetResampler.degraded); per-bucket detail is in
        degraded_buckets()."""
        return any(b.fleet.degraded for b in self._buckets.values())

    def degraded_buckets(self) -> dict:
        return {str(k): b.fleet.degraded for k, b in self._buckets.items()}

    # -- checkpoint/resume (SURVEY.md §5: the state IS a checkpoint) ---------

    def state_dict(self) -> dict:
        """Full serializable snapshot of the heterogeneous serving state:
        every bucket's fleet (filter history, staging, occupancy), every
        stream's bookkeeping/carryover, and live rate-switch transitions
        (their core state + buffered input)."""
        return {
            "channels": self.channels, "capacity": self.capacity,
            "fixed_point": self.fixed_point,
            "buckets": {k: {"fleet": b.fleet.state_dict(),
                            "free": list(b.free)}
                        for k, b in self._buckets.items()},
            # idle-LRU recency order (oldest first) so a restore evicts
            # in the donor's order, not state-dict iteration order
            "idle": list(self._idle),
            "streams": {sid: {
                "key": st.key, "slot": st.slot,
                "real_frames": st.real_frames, "pulled": st.pulled,
                "ended": st.ended,
                "carryover": (None if st.carryover is None
                              else st.carryover.copy()),
                "byte_carry": st.byte_carry,
                "transition": (None if st.transition is None else {
                    "core": st.transition.core.state_dict(),
                    "buf": st.transition.buf.copy(),
                    "fed": st.transition.fed,
                }),
            } for sid, st in self._streams.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        if (state["channels"], state["capacity"]) != (self.channels,
                                                      self.capacity) or \
                state.get("fixed_point", False) != self.fixed_point:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG)
        self._buckets = {}
        self._idle = {}
        for k, bs in state["buckets"].items():
            ir, orr, q = k
            b = _Bucket(self._new_fleet(ir, orr, q))
            # load AFTER _Bucket's blanket deactivation: it restores the
            # true per-slot occupancy along with histories and staging
            b.fleet.load_state_dict(bs["fleet"])
            b.free = list(bs["free"])
            self._buckets[k] = b
        # restored-empty buckets join the idle LRU (and the cap applies,
        # so a restore cannot resurrect an unbounded set) — replaying the
        # donor's recency order first so post-restore eviction picks the
        # donor's oldest idle config, not an arbitrary recently-used one
        donor_order = [tuple(k) for k in state.get("idle", [])]
        rest = [k for k in state["buckets"] if tuple(k) not in
                set(donor_order)]
        for k in donor_order + rest:
            if tuple(k) in self._buckets:
                self._note_slot_released(tuple(k))
        self._streams = {}
        for sid, ss in state["streams"].items():
            st = _Stream(key=tuple(ss["key"]), slot=ss["slot"],
                         real_frames=int(ss["real_frames"]),
                         pulled=int(ss["pulled"]), ended=bool(ss["ended"]))
            if ss["carryover"] is not None:
                st.carryover = np.array(ss["carryover"], dtype=np.int16)
            if ss["byte_carry"]:
                st.byte_carry = bytes(ss["byte_carry"])
            if ss["transition"] is not None:
                core = ResamplerCore(self.channels, 1, 1, 1, 1, 4,
                                     fixed_point=self.fixed_point)
                core.load_state_dict(ss["transition"]["core"])
                tr = _Transition(core, self.channels)
                tr.buf = np.array(ss["transition"]["buf"], dtype=np.int16)
                # pre-"fed" snapshots default to True: the old behavior
                # (finish() at a chained switch) never loses data
                tr.fed = bool(ss["transition"].get("fed", True))
                st.transition = tr
            self._streams[sid] = st

    # -- internals -----------------------------------------------------------

    def _stream(self, sid) -> _Stream:
        try:
            return self._streams[sid]
        except KeyError:
            raise ResamplerError(ResamplerErrorCode.INVALID_ARG) from None

    def _collect(self, sid) -> np.ndarray:
        st = self._streams[sid]
        out = self._buckets[st.key].fleet.pull(st.slot)
        st.pulled += out.shape[0]
        return out

    def _drop_slot(self, st: _Stream):
        """Free the bucket slot (caller has already salvaged its output)."""
        b = self._buckets[st.key]
        b.fleet.set_slot_active(st.slot, False)
        b.fleet._out[st.slot] = []
        b.free.append(st.slot)
        st.slot = None
        self._note_slot_released(st.key)

    def _gc(self, sid):
        st = self._streams.get(sid)
        if st is None or not st.ended or st.slot is not None:
            return
        if st.carryover is None or not len(st.carryover):
            self._streams.pop(sid, None)

