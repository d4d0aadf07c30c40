"""Backpressure / bounded host memory for the serving engines.

The reference's streaming surface is a Node Transform
(src/index.ts:121-162): it inherits stream backpressure — a slow consumer
pauses the producer through the callback/highWaterMark machinery.  The
fleet engines' explicit analog (round-4): per-stream ``max_staged_frames``
(push raises ALLOC_FAILED past it; ``writable()`` is the pause signal) and
``max_banked_frames`` (``poll()`` stops launching while a stream's banked
output sits at the watermark).  The invariant under a push-only /
never-pull workload: staged <= max_staged, banked <= max_banked +
pipeline-depth * out_per_launch — memory bounded by config, forever.
"""

import numpy as np
import pytest

from speex_resampler_tpu.runtime.fleet import FleetResampler
from speex_resampler_tpu.runtime.multifleet import MultiFleet
from speex_resampler_tpu.utils.errors import (ResamplerError,
                                              ResamplerErrorCode)

S, C = 4, 2
RATES = (24000, 48000, 5)   # num=1, den=2: small dense quantum


def _fleet(**kw):
    return FleetResampler(S, C, *RATES, target_chunk_frames=256, **kw)


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-32768, 32768, size=(n, C)) // 2).astype(np.int16)


def test_constructor_validation():
    with pytest.raises(ResamplerError) as e:
        _fleet(max_staged_frames=0)
    assert e.value.code == ResamplerErrorCode.INVALID_ARG
    with pytest.raises(ResamplerError):
        _fleet(max_banked_frames=-1)
    # a staging watermark below the launch quantum can never reach
    # lockstep readiness: config error
    q = _fleet().bspec.in_per_launch
    with pytest.raises(ResamplerError) as e:
        _fleet(max_staged_frames=q - 1)
    assert e.value.code == ResamplerErrorCode.INVALID_ARG


def test_push_only_never_pull_stays_bounded():
    """The round-3 incident scenario: a consumer that polls but never
    pulls.  Memory must stay bounded by the watermarks no matter how much
    the producer offers."""
    q = _fleet().bspec.in_per_launch
    fleet = _fleet(max_staged_frames=4 * q, max_banked_frames=3 * q)
    out_q = fleet.bspec.out_per_launch
    chunk = _frames(q)
    rejections = 0
    for _ in range(64):  # far more input than the bounds can hold
        for s in range(S):
            try:
                fleet.push(s, chunk)
            except ResamplerError as e:
                assert e.code == ResamplerErrorCode.ALLOC_FAILED
                rejections += 1
        fleet.poll()
        # the bound, every iteration: staged and banked never exceed
        # watermark (+ pipeline_depth in-flight launches for banked;
        # default depth 2)
        for s in range(S):
            assert fleet.staged()[s] <= 4 * q
            assert fleet.pending(s) <= 3 * q + 2 * out_q
    assert rejections > 0, "producer was never paused"
    # consumer wakes up: pulling drains the bank, poll resumes, pushes
    # are accepted again
    for s in range(S):
        assert fleet.pull(s).shape[0] > 0
    assert fleet.poll() > 0
    for s in range(S):
        assert fleet.writable(s) or fleet.staged()[s] >= 4 * q
    fleet.pull(0)
    fleet.push(0, chunk[:1])  # does not raise


def test_writable_signal_and_push_bytes():
    q = _fleet().bspec.in_per_launch
    fleet = _fleet(max_staged_frames=q)
    assert fleet.writable(0)
    fleet.push(0, _frames(q))
    assert not fleet.writable(0)
    with pytest.raises(ResamplerError):
        fleet.push(0, _frames(1))
    # push_bytes counts whole frames incl. the alignment carry
    fleet.push_bytes(1, _frames(q).tobytes()[:-1])  # q-1 frames + carry
    assert fleet.writable(1)
    with pytest.raises(ResamplerError):
        fleet.push_bytes(1, _frames(2).tobytes())  # carry completes 2 more
    fleet.push_bytes(1, b"\x00")  # completes exactly frame q: accepted
    assert not fleet.writable(1)


def test_outputs_identical_with_and_without_watermarks():
    """Backpressure must never change WHAT is produced, only when."""
    q = _fleet().bspec.in_per_launch
    a = _fleet()
    b = _fleet(max_staged_frames=2 * q, max_banked_frames=q)
    data = _frames(6 * q, seed=3)
    for s in range(S):
        a.push(s, data)
    a.poll()
    got_a = [a.pull(s) for s in range(S)]
    got_b = [[] for _ in range(S)]
    i = 0
    while i < 6 * q or any(b.staged()[s] for s in range(S)):
        n = min(q // 2, 6 * q - i)
        if n:
            for s in range(S):
                while not b.writable(s):
                    b.poll()
                    got_b[s].append(b.pull(s))
                b.push(s, data[i:i + n])
            i += n
        b.poll()
        for s in range(S):
            got_b[s].append(b.pull(s))
    for s in range(S):
        np.testing.assert_array_equal(got_a[s],
                                      np.concatenate(got_b[s], axis=0))


def test_multifleet_watermarks():
    mf = MultiFleet(channels=C, capacity_per_bucket=4,
                    target_chunk_frames=256,
                    max_staged_frames=600, max_banked_frames=600)
    mf.add_stream("a", *RATES)
    mf.add_stream("b", 44100, 48000, 7)
    q = mf._buckets[RATES].fleet.bspec.in_per_launch
    chunk = _frames(q)
    raised = False
    for _ in range(32):
        for sid in ("a", "b"):
            try:
                mf.push(sid, chunk)
            except ResamplerError as e:
                assert e.code == ResamplerErrorCode.ALLOC_FAILED
                raised = True
        mf.poll()
    assert raised
    # writable() mirrors push acceptance: paused streams report False and
    # pulling everything makes them writable again
    for sid in ("a", "b"):
        if not mf.writable(sid):
            with pytest.raises(ResamplerError):
                mf.push(sid, _frames(1))
    # pulling reopens the pipeline
    assert mf.pull("a").shape[0] > 0
    mf.poll()
    total = mf.pull("a").shape[0]
    assert total >= 0
    while mf.pull("a").shape[0] or mf.poll():
        pass
    assert mf.writable("a")
    mf.push("a", _frames(1))  # does not raise


def test_writable_takes_chunk_size():
    """writable(stream, n) guarantees acceptance of an n-frame push —
    the README producer pattern for multi-frame chunks (round-4 review:
    the 1-frame default only guards the next single frame)."""
    q = _fleet().bspec.in_per_launch
    fleet = _fleet(max_staged_frames=q + 8)
    fleet.push(0, _frames(q))
    assert fleet.writable(0)            # room for 1 more
    assert fleet.writable(0, 8)         # exactly fits
    assert not fleet.writable(0, 9)     # would cross the watermark
    with pytest.raises(ResamplerError):
        fleet.push(0, _frames(9))
    fleet.push(0, _frames(8))           # writable() promised this fits


def _mid_transition_multifleet(max_staged, max_banked):
    """A MultiFleet with stream "a" parked mid rate-switch: start on
    44.1k->48k (den=160 — the fractional phase after a polled launch is
    generically nonzero), then switch to 48k->44.1k (den=147) with too
    little buffered input for the transition to reach phase 0."""
    mf = MultiFleet(channels=C, capacity_per_bucket=4,
                    target_chunk_frames=256,
                    max_staged_frames=max_staged,
                    max_banked_frames=max_banked)
    mf.add_stream("a", 44100, 48000, 7)
    q = mf._buckets[(44100, 48000, 7)].fleet.bspec.in_per_launch
    mf.push("a", _frames(q + 37, seed=1))
    mf.poll()
    mf.set_stream_rate("a", 48000, 44100)
    st = mf._stream("a")
    assert st.transition is not None, \
        "scenario failed to leave a live transition"
    return mf, st


def test_transition_restage_bypasses_watermark():
    """Frames the engine already accepted must never be re-subjected to
    backpressure when a completed rate-switch transition re-stages its
    retained-unconsumed input into the new bucket (round-4 review: the
    watermark-checked push here raised ALLOC_FAILED out of MultiFleet.push
    and silently dropped the stream's input)."""
    mf, st = _mid_transition_multifleet(700, 100000)
    # force the exact hazard: at completion the retained-unconsumed input
    # exceeds the staging watermark (the transition stops consuming at its
    # phase-0 point, so nearly all of this survives to staged_rest)
    st.transition.buf = np.concatenate(
        [st.transition.buf, _frames(900, seed=2)])
    mf.push("a", _frames(1, seed=3))    # within watermark; completes it
    assert st.transition is None, "transition should complete on this push"
    slot_staged = mf._buckets[st.key].fleet._stager.staged_one(st.slot)
    assert slot_staged > 700, \
        f"hazard not exercised: only {slot_staged} frames re-staged"
    mf.poll()
    assert mf.pull("a").shape[0] > 0


def test_transition_push_bytes_refusal_changes_nothing():
    """A refused mid-transition push_bytes must leave the stream's byte
    carry (and everything else) untouched — the pre-fix code overwrote
    st.byte_carry BEFORE the watermark check fired inside push(), so the
    aligned bytes were silently dropped and the carry corrupted."""
    W, Q = 200, 700
    mf, st = _mid_transition_multifleet(Q, W)
    mf.pull("a")
    # establish a nonzero byte carry, then saturate the banked watermark
    mf.push_bytes("a", _frames(3).tobytes() + b"\x55")
    carry_before = st.byte_carry
    assert carry_before == b"\x55"
    st.carryover = _frames(W)           # carryover at the watermark
    data = _frames(Q + 1).tobytes()     # over the per-chunk bound too
    with pytest.raises(ResamplerError) as e:
        mf.push_bytes("a", data)
    assert e.value.code == ResamplerErrorCode.ALLOC_FAILED
    assert st.byte_carry == carry_before, "refusal corrupted the carry"
    assert st.transition is not None
    # consumer drains; the SAME bytes are then accepted in bounded pieces
    # with no duplication or loss: total replay = carry + data frames
    mf.pull("a")
    accepted = 0
    step = (Q // 2) * C * 2             # 350-frame pieces, well inside Q
    for i in range(0, len(data), step):
        mf.pull("a")
        accepted += mf.push_bytes("a", data[i:i + step])
    total_bytes = len(carry_before) + len(data)
    assert accepted == total_bytes // (2 * C)
    rem = (st.byte_carry if st.transition is not None
           else mf._buckets[st.key].fleet.lane_carry(st.slot))
    assert len(rem) == total_bytes % (2 * C)


def test_transition_carryover_bounded():
    """Mid-transition pushes bank output into carryover; the watermarks
    must bound it (round-4 review).  The transition itself can emit at
    most den-1 frames before completing, so the binding check is that a
    single over-watermark chunk is refused exactly as the lockstep path
    would refuse it, and carryover stays within max_banked + den."""
    W, Q = 200, 700
    mf, st = _mid_transition_multifleet(Q, W)
    mf.pull("a")   # drain the pre-switch launch output banked at switch
    with pytest.raises(ResamplerError) as e:
        mf.push("a", _frames(Q + 1))
    assert e.value.code == ResamplerErrorCode.ALLOC_FAILED
    assert not mf.writable("a", Q + 1)
    assert st.transition is not None    # the refused chunk changed nothing
    # tiny accepted chunks: carryover stays within watermark + den tail
    for i in range(64):
        if st.transition is None:
            break
        mf.push("a", _frames(8, seed=i))
        if st.carryover is not None:
            assert len(st.carryover) <= W + 147
    assert st.transition is None, "transition never completed"


def test_writable_false_after_flush():
    """flush() is terminal: push() always raises afterwards, so the pause
    signal must report not-writable instead of green-lighting a push
    that is guaranteed to fail (the documented writable->push pattern)."""
    fl = _fleet(max_staged_frames=4096)
    fl.push(0, _frames(64))
    assert fl.writable(0, 64)
    fl.flush()
    assert not fl.writable(0, 1)
    with pytest.raises(ResamplerError):
        fl.push(0, _frames(1))
    # unbounded engines flush too: same contract
    fl2 = _fleet()
    fl2.flush()
    assert not fl2.writable(0, 1)
