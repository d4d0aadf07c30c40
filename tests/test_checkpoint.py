"""Checkpoint/resume: the streaming state is a serializable snapshot
(SURVEY.md §5; SpeexResamplerState_ fields, resample.c:134-139).

Contract: resuming from a mid-stream snapshot produces exactly the samples
the uninterrupted run produces.
"""

import pickle

import numpy as np
import pytest

from speex_resampler_tpu.core.resampler import ResamplerCore
from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.runtime.fleet import FleetResampler
from speex_resampler_tpu.runtime.native import load_runtime


def _chunks(x, sizes):
    pos = 0
    for n in sizes:
        yield x[pos:pos + n]
        pos += n
    yield x[pos:]


def test_core_checkpoint_roundtrip():
    rng = np.random.default_rng(0)
    x = (rng.integers(-32768, 32768, size=(9000, 2)) // 2).astype(np.int16)

    ref = ResamplerCore(2, 44100, 48000, 44100, 48000, 7)
    full = np.concatenate([ref.process_interleaved(c, 10**9)
                           for c in _chunks(x, [3000, 2500])])

    a = ResamplerCore(2, 44100, 48000, 44100, 48000, 7)
    out1 = a.process_interleaved(x[:3000], 10**9)
    blob = pickle.dumps(a.state_dict())

    b = ResamplerCore(2, 44100, 48000, 44100, 48000, 7)
    b.load_state_dict(pickle.loads(blob))
    out2 = b.process_interleaved(x[3000:5500], 10**9)
    out3 = b.process_interleaved(x[5500:], 10**9)
    resumed = np.concatenate([out1, out2, out3])
    assert np.array_equal(resumed, full)


def test_core_checkpoint_restores_mem_alloc_high_water():
    """A restore must adopt the donor's mem_alloc_size EXACTLY — keeping a
    larger local high-water mark changes xlen (the process loops' input
    bite) and desyncs capacity-bound consumed-input accounting from the
    snapshotted stream.  Regression: load_state_dict used max(local,
    saved)."""
    rng = np.random.default_rng(9)
    x = (rng.integers(-32768, 32768, size=(4000, 1)) // 2).astype(np.int16)

    donor = ResamplerCore(1, 44100, 48000, 44100, 48000, 3)
    donor.process_interleaved(x[:1000], 10 ** 9)
    blob = pickle.dumps(donor.state_dict())

    # host core first ran at q10: its own high-water mark exceeds q3's
    host = ResamplerCore(1, 44100, 48000, 44100, 48000, 10)
    host.process_interleaved(x[:500], 10 ** 9)
    assert host._mem_alloc_size > donor._mem_alloc_size
    host.load_state_dict(pickle.loads(blob))
    assert host._mem_alloc_size == donor._mem_alloc_size

    # capacity-bound bite quantization must now match the donor exactly
    for chunk in _chunks(x[1000:], [700, 900]):
        yd = donor.process_interleaved(chunk, 37)
        yh = host.process_interleaved(chunk, 37)
        assert np.array_equal(yd, yh)
        assert donor.last_accounting == host.last_accounting


def test_core_checkpoint_after_rate_switch():
    """Snapshot taken while magic samples are pending must survive."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-32768, 32768, size=(6000, 1)) // 2).astype(np.int16)

    def run(snapshot_at_switch):
        core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7)
        outs = [core.process_interleaved(x[:2000], 10**9)]
        core.set_quality(3)          # filter shrink -> magic samples stashed
        core.set_rate(44100, 24000)
        if snapshot_at_switch:
            blob = pickle.dumps(core.state_dict())
            core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7)
            core.load_state_dict(pickle.loads(blob))
        outs.append(core.process_interleaved(x[2000:], 10**9))
        return np.concatenate(outs)

    assert np.array_equal(run(False), run(True))


def test_batched_checkpoint_roundtrip():
    rng = np.random.default_rng(2)
    S, C = 2, 2
    frames = (rng.integers(-32768, 32768, size=(S, 8000, C)) // 2).astype(
        np.int16)

    ref = BatchedResampler(S, C, 44100, 48000, 7)
    full = np.concatenate([ref.process(frames), ref.flush()], axis=1)

    a = BatchedResampler(S, C, 44100, 48000, 7)
    out1 = a.process(frames[:, :3000])
    blob = pickle.dumps(a.state_dict())

    b = BatchedResampler(S, C, 44100, 48000, 7)
    b.load_state_dict(pickle.loads(blob))
    out2 = b.process(frames[:, 3000:])
    out3 = b.flush()
    resumed = np.concatenate([out1, out2, out3], axis=1)
    assert np.array_equal(resumed, full)


@pytest.mark.skipif(load_runtime() is None,
                    reason="native runtime not buildable")
def test_fleet_checkpoint_roundtrip():
    rng = np.random.default_rng(3)
    S, C = 2, 1
    frames = (rng.integers(-32768, 32768, size=(S, 7000, C)) // 2).astype(
        np.int16)

    ref = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=1024)
    for s in range(S):
        ref.push(s, frames[s])
    ref.poll()
    ref.flush()
    full = [ref.pull(s) for s in range(S)]

    a = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=1024)
    for s in range(S):
        raw = frames[s, :4000].astype("<i2").tobytes()
        a.push_bytes(s, raw[:5555])       # unaligned split -> carry bytes
        a.push_bytes(s, raw[5555:])
    a.poll()
    blob = pickle.dumps(a.state_dict())

    b = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=1024)
    b.load_state_dict(pickle.loads(blob))
    for s in range(S):
        b.push_bytes(s, frames[s, 4000:].astype("<i2").tobytes())
    b.poll()
    b.flush()
    for s in range(S):
        assert np.array_equal(b.pull(s), full[s])


def test_fleet_checkpoint_preserves_active_flags_and_config():
    """Restoring a snapshot with inactive slots must not reactivate them
    (a fresh stager defaults to all-active, which would stall
    ready_launches); loading into a mismatched-config fleet must raise."""
    from speex_resampler_tpu.utils.errors import ResamplerError

    S, C = 4, 1
    f = FleetResampler(S, C, 24000, 48000, 5, target_chunk_frames=256)
    q = f.bspec.in_per_launch
    f.set_slot_active(1, False)
    f.set_slot_active(3, False)
    rng = np.random.default_rng(9)
    for s in (0, 2):
        f.push(s, (rng.integers(-1000, 1000, size=(q, C))).astype(np.int16))
    state = f.state_dict()

    g = FleetResampler(S, C, 24000, 48000, 5, target_chunk_frames=256)
    g.load_state_dict(state)
    # active slots 0 and 2 both hold a full quantum: must be ready
    assert g.poll() == 1
    assert g.pending(0) > 0 and g.pending(2) > 0

    bad = FleetResampler(S, C, 24000, 44100, 5, target_chunk_frames=256)
    with pytest.raises(ResamplerError):
        bad.load_state_dict(state)


def test_multifleet_checkpoint_roundtrip():
    """Snapshot the whole heterogeneous serving state mid-everything — one
    stream mid-rate-switch-transition, one streaming normally — restore
    into a fresh MultiFleet, continue both, and match the uninterrupted
    run."""
    from speex_resampler_tpu.runtime.multifleet import MultiFleet

    rng = np.random.default_rng(17)
    xa = (rng.integers(-20000, 20000, size=(2500, 1))).astype(np.int16)
    xb = (rng.integers(-20000, 20000, size=(2500, 1))).astype(np.int16)

    def drive(mf, until_snapshot_only=False):
        mf.add_stream("u", 24000, 48000, 5)
        mf.add_stream("v", 44100, 48000, 7)
        mf.push("u", xa)
        mf.push("v", xa)
        mf.poll()
        mf.set_stream_rate("u", 44100, 48000, 7)  # enters transition
        if until_snapshot_only:
            return None
        return finish(mf)

    def finish(mf):
        mf.push("u", xb)
        mf.push("v", xb)
        mf.flush()
        return {s: mf.pull(s) for s in ("u", "v")}

    ref_mf = MultiFleet(channels=1, capacity_per_bucket=2,
                        target_chunk_frames=512)
    want = drive(ref_mf)

    mf1 = MultiFleet(channels=1, capacity_per_bucket=2,
                     target_chunk_frames=512)
    drive(mf1, until_snapshot_only=True)
    blob = pickle.dumps(mf1.state_dict())

    mf2 = MultiFleet(channels=1, capacity_per_bucket=2,
                     target_chunk_frames=512)
    mf2.load_state_dict(pickle.loads(blob))
    got = finish(mf2)
    for s in ("u", "v"):
        assert got[s].shape == want[s].shape, (s, got[s].shape,
                                               want[s].shape)
        assert np.array_equal(got[s], want[s]), s


def _legacy_hist(hist, filt_len, fill):
    """Re-layout a checkpointed history the way older engines wrote it:
    filt_len-1 valid rows padded in front to a 16-row multiple.  The pad
    rows are zeros or, for ``fill="garbage"``, arbitrary samples that a
    restore must never read."""
    hist = np.asarray(hist)
    rows = -(-(filt_len - 1) // 16) * 16
    assert rows > hist.shape[0], "needs extra alignment rows"
    pad = np.zeros((rows - hist.shape[0], hist.shape[1]), np.int16)
    if fill == "garbage":
        pad[:] = 12345
    return np.concatenate([pad, hist], axis=0)


@pytest.mark.parametrize("fill", ["zeros", "garbage"])
def test_legacy_hist_geometry_restore(fill):
    """A checkpoint whose history carries extra leading alignment rows
    (written by older engines, whose history was filt_len-1 rounded up to
    16 rows) restores into today's engine: _adapt_hist keeps the trailing
    filt_len-1 valid rows, so the resumed run is bit-identical to an
    uninterrupted one.  Before the adapter, the mis-shaped hist was
    accepted and the first dispatch failed INSIDE the degradation guard
    -> permanent silent zero output.  FIXED universe: bit-exact."""
    S, C, n = 2, 1, 3200
    rng = np.random.default_rng(11)
    x = (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(np.int16)

    def engine():
        return BatchedResampler(S, C, 44100, 48000, 7, fixed_point=True)

    ref = engine()
    full = np.concatenate([ref.process(x), ref.flush()], axis=1)

    a, b = engine(), engine()
    y1 = a.process(x[:, :2000])
    sd = a.state_dict()
    sd["hist"] = _legacy_hist(sd["hist"], a.spec.filt_len, fill)
    b.load_state_dict(pickle.loads(pickle.dumps(sd)))
    y2 = np.concatenate([b.process(x[:, 2000:]), b.flush()], axis=1)
    resumed = np.concatenate([y1, y2], axis=1)
    assert resumed.shape == full.shape
    assert np.array_equal(resumed, full)


def test_restore_rejects_wrong_hist_columns():
    """A hist whose lane axis disagrees with the engine geometry must
    raise INVALID_ARG up front, never enter the dispatch path."""
    from speex_resampler_tpu.utils.errors import ResamplerError

    a = BatchedResampler(2, 1, 44100, 48000, 7)
    sd = a.state_dict()
    sd["hist"] = np.zeros((np.asarray(sd["hist"]).shape[0], 7), np.int16)
    b = BatchedResampler(2, 1, 44100, 48000, 7)
    with pytest.raises(ResamplerError):
        b.load_state_dict(sd)
    # too few rows to contain filt_len-1 valid history: also rejected
    sd2 = a.state_dict()
    sd2["hist"] = np.asarray(sd2["hist"])[-3:]
    with pytest.raises(ResamplerError):
        b.load_state_dict(sd2)


def test_fleet_legacy_hist_restore():
    """Same legacy-geometry restore at the fleet level: checkpoint a fleet,
    re-layout its history with garbage-filled leading alignment rows,
    restore into a fresh fleet; total output equals an uninterrupted
    fleet.  FIXED universe: bit-exact."""
    S, C = 2, 1
    a = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=512,
                       fixed_point=True)
    # head must exceed the launch quantum so a REAL launch populates the
    # history before the checkpoint (otherwise the adapter only ever sees
    # zeros)
    head = 2 * a.bspec.in_per_launch
    rng = np.random.default_rng(13)
    x = [(rng.integers(-32768, 32768, size=(head + 1100, C)) // 2)
         .astype(np.int16) for _ in range(S)]

    def drive_tail(fl):
        for s in range(S):
            fl.push(s, x[s][head:])
        fl.poll()
        fl.flush()
        return [fl.pull(s) for s in range(S)]

    ref = FleetResampler(S, C, 44100, 48000, 7,
                         target_chunk_frames=512, fixed_point=True)
    for s in range(S):
        ref.push(s, x[s][:head])
    ref.poll()
    want_head = [ref.pull(s) for s in range(S)]
    want_tail = drive_tail(ref)

    for s in range(S):
        a.push(s, x[s][:head])
    a.poll()
    got_head = [a.pull(s) for s in range(S)]
    assert min(len(h) for h in got_head) > 0, "no launch before checkpoint"
    sd = a.state_dict()
    sd["hist"] = _legacy_hist(sd["hist"], a.spec.filt_len, "garbage")
    blob = pickle.dumps(sd)

    b = FleetResampler(S, C, 44100, 48000, 7,
                       target_chunk_frames=512, fixed_point=True)
    b.load_state_dict(pickle.loads(blob))
    got_tail = drive_tail(b)

    # the checkpoint contract is total-output equality
    for s in range(S):
        got = np.concatenate([got_head[s], got_tail[s]])
        want = np.concatenate([want_head[s], want_tail[s]])
        assert np.array_equal(got, want), s
