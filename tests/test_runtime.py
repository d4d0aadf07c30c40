"""Native host runtime (C++ stager) and FleetResampler tests.

The native stager must behave identically to the NumPy reference
implementation (PyStager), and the fleet front-end must reproduce the
single-stream golden-tested core per stream.
"""

import numpy as np
import pytest

from speex_resampler_tpu.core.resampler import ResamplerCore
from speex_resampler_tpu.runtime.native import (NativeStager, PyStager,
                                                load_runtime)
from speex_resampler_tpu.runtime.fleet import FleetResampler
from speex_resampler_tpu.utils.errors import ResamplerError

from conftest import assert_lsb_close

pytestmark = pytest.mark.skipif(load_runtime() is None,
                                reason="native runtime not buildable")


def _both(S, C, q):
    return NativeStager(S, C, q), PyStager(S, C, q)


def test_stager_fill_launch_matches_numpy():
    rng = np.random.default_rng(0)
    S, C, q = 3, 2, 100
    nat, ref = _both(S, C, q)
    for rep in range(4):
        for s in range(S):
            n = int(rng.integers(30, 200))
            f = rng.integers(-1000, 1000, size=(n, C)).astype(np.int16)
            nat.push(s, f)
            ref.push(s, f)
        assert np.array_equal(nat.staged(), ref.staged())
        assert nat.ready_launches() == ref.ready_launches()
        while ref.ready_launches():
            a = nat.fill_launch()
            b = ref.fill_launch()
            assert np.array_equal(a, b)
    assert np.array_equal(nat.staged(), ref.staged())


@pytest.mark.parametrize("C", [1, 2, 3])
def test_stager_lane_major_matches_numpy_and_time_major(C):
    """The lane-major fast path (srt_fill_launch_lm / srt_unpack_all_lm,
    used by FleetResampler with the device-side transpose) must agree with
    the PyStager reference AND with the time-major twins transposed."""
    rng = np.random.default_rng(7 + C)
    S, q = 5, 48
    nat, ref = _both(S, C, q)
    nat.set_active(3, False)
    ref.set_active(3, False)
    for s in range(S):
        if s == 3:
            continue
        f = rng.integers(-1000, 1000, size=(q + 5, C)).astype(np.int16)
        nat.push(s, f)
        ref.push(s, f)
    stride = q + 9
    a = np.full((S * C, stride), 7, dtype=np.int16)
    b = np.full((S * C, stride), 7, dtype=np.int16)
    nat.fill_launch_lm(a)
    ref.fill_launch_lm(b)
    assert np.array_equal(a[:, :q], b[:, :q])
    # the zero tail beyond n_in is never touched (persistent slabs rely
    # on it), and the inactive lane's quantum is zero-filled
    assert np.all(a[:, q:] == 7) and np.all(b[:, q:] == 7)
    assert not a[3 * C:4 * C, :q].any()
    assert np.array_equal(nat.staged(), ref.staged())

    y = rng.integers(-2000, 2000, size=(S * C, 31)).astype(np.int16)
    u_nat = nat.unpack_all_lm(y)
    assert np.array_equal(u_nat, ref.unpack_all_lm(y))
    assert np.array_equal(u_nat, nat.unpack_all(np.ascontiguousarray(y.T)))
    # destination-buffer reuse writes the identical result
    dst = np.empty_like(u_nat)
    assert np.array_equal(nat.unpack_all_lm(y, out=dst), u_nat)


def test_stager_push_bytes_alignment_carry():
    S, C, q = 2, 2, 50
    nat, ref = _both(S, C, q)
    rng = np.random.default_rng(1)
    data = rng.integers(-500, 500, size=(333, C)).astype("<i2").tobytes()
    # split at arbitrary byte boundaries (not frame-aligned)
    cuts = sorted(rng.integers(1, len(data), size=7))
    pieces = [data[a:b] for a, b in zip([0] + cuts, cuts + [len(data)])]
    for p in pieces:
        na = nat.push_bytes(0, p)
        nb = ref.push_bytes(0, p)
        assert na == nb
    assert nat.staged()[0] == ref.staged()[0] == 333


def test_stager_flush_and_unpack():
    rng = np.random.default_rng(2)
    S, C, q = 4, 2, 64
    nat, ref = _both(S, C, q)
    for s in range(S):
        n = int(rng.integers(1, q))  # every stream short of a launch
        f = rng.integers(-1000, 1000, size=(n, C)).astype(np.int16)
        nat.push(s, f)
        ref.push(s, f)
    a_slab, a_staged = nat.fill_flush()
    b_slab, b_staged = ref.fill_flush()
    assert np.array_equal(a_staged, b_staged)
    assert np.array_equal(a_slab, b_slab)
    # nothing left
    assert nat.ready_launches() == 0 and nat.staged().max() == 0

    y = rng.integers(-1000, 1000, size=(37, S * C)).astype(np.int16)
    assert np.array_equal(nat.unpack_all(y), ref.unpack_all(y))
    for s in range(S):
        assert np.array_equal(nat.unpack(y, s), ref.unpack(y, s))


def test_stager_empty_flush():
    nat = NativeStager(2, 1, 32)
    slab, staged = nat.fill_flush()
    assert slab is None and staged.max() == 0


def test_fleet_matches_single_stream_core():
    rng = np.random.default_rng(3)
    S, C = 3, 2
    n = 9000
    frames = (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(
        np.int16)
    fleet = FleetResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)
    # ragged pushes at per-stream cadence
    pos = [0] * S
    while min(pos) < n:
        for s in range(S):
            step = int(rng.integers(100, 900))
            nxt = min(pos[s] + step, n)
            if nxt > pos[s]:
                fleet.push(s, frames[s, pos[s]:nxt])
                pos[s] = nxt
        fleet.poll()
    fleet.flush()

    for s in range(S):
        got = fleet.pull(s)
        core = ResamplerCore(C, 44100, 48000, 44100, 48000, 7)
        ref = core.process_interleaved(frames[s], 10**9)
        m = min(got.shape[0], ref.shape[0])
        assert abs(got.shape[0] - ref.shape[0]) <= 1
        assert_lsb_close(got[:m].ravel(), ref[:m].ravel())
        assert fleet.pull(s).shape[0] == 0  # drained


def test_fleet_flush_drains_multiple_quanta():
    """flush() must drain EVERYTHING staged, not one quantum per stream:
    when lockstep readiness was gated by an emptier stream, another stream
    can sit on several quanta.  Regression: fill_flush caps each stream at
    one quantum per call and flush() called it once, silently losing the
    rest.  flush() is also terminal: further pushes must raise."""
    rng = np.random.default_rng(11)
    S, C = 2, 1
    fleet = FleetResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=512)
    q = fleet.bspec.in_per_launch
    n0, n1 = int(2.5 * q), q // 3
    frames0 = (rng.integers(-32768, 32768, size=(n0, C)) // 2).astype(
        np.int16)
    frames1 = (rng.integers(-32768, 32768, size=(n1, C)) // 2).astype(
        np.int16)
    fleet.push(0, frames0)
    fleet.push(1, frames1)
    assert fleet.poll() == 0  # stream 1 gates lockstep readiness
    fleet.flush()

    for s, frames in ((0, frames0), (1, frames1)):
        got = fleet.pull(s)
        core = ResamplerCore(C, 44100, 48000, 44100, 48000, 7)
        ref = core.process_interleaved(frames, 10 ** 9)
        assert abs(got.shape[0] - ref.shape[0]) <= 1, (s, got.shape,
                                                       ref.shape)
        m = min(got.shape[0], ref.shape[0])
        assert_lsb_close(got[:m].ravel(), ref[:m].ravel())

    with pytest.raises(ResamplerError):
        fleet.push(0, frames1)
    with pytest.raises(ResamplerError):
        fleet.push_bytes(0, b"\x00\x00")
    fleet.flush()  # repeat flush stays a no-op, not an error


def test_fleet_push_bytes_roundtrip():
    rng = np.random.default_rng(4)
    S, C = 2, 1
    n = 5000
    frames = (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(
        np.int16)
    fleet = FleetResampler(S, C, 24000, 48000, 5,
                           target_chunk_frames=512)
    for s in range(S):
        raw = frames[s].astype("<i2").tobytes()
        cuts = sorted(rng.integers(1, len(raw), size=5))
        for a, b in zip([0] + cuts, cuts + [len(raw)]):
            fleet.push_bytes(s, raw[a:b])
    fleet.poll()
    fleet.flush()
    for s in range(S):
        got = fleet.pull(s)
        core = ResamplerCore(C, 24000, 48000, 24000, 48000, 5)
        ref = core.process_interleaved(frames[s], 10**9)
        m = min(got.shape[0], ref.shape[0])
        assert m > 0
        assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


def test_native_stager_threads_match_serial():
    """The gather/scatter thread pool must be output-invariant across pool
    sizes (the 1-vCPU CI host can't show scaling; correctness is what this
    pins — disjoint row/stream ranges, atomic chunk distribution)."""
    from speex_resampler_tpu.runtime.native import (NativeStager,
                                                    load_runtime)
    if load_runtime() is None:
        pytest.skip("native runtime unavailable")
    S, C, N_IN = 37, 2, 513   # deliberately non-round
    rng = np.random.default_rng(77)
    frames = rng.integers(-32768, 32768, size=(S, N_IN, C)).astype(np.int16)
    y = rng.integers(-32768, 32768, size=(700, S * C)).astype(np.int16)

    ref_slab = ref_unpack = None
    for n in (1, 2, 4, 7):
        st = NativeStager(S, C, N_IN)
        assert st.set_threads(n) == n
        for s in range(S):
            st.push(s, frames[s])
        slab = st.fill_launch()
        unp = st.unpack_all(y)
        if ref_slab is None:
            ref_slab, ref_unpack = slab, unp
        else:
            assert np.array_equal(slab, ref_slab)
            assert np.array_equal(unp, ref_unpack)
        # ragged flush path
        for s in range(S):
            st.push(s, frames[s][: (s * 13) % N_IN])
        fslab, staged = st.fill_flush()
        if n == 1:
            ref_flush = (fslab.copy() if fslab is not None else None, staged)
        else:
            assert np.array_equal(fslab, ref_flush[0])
            assert np.array_equal(staged, ref_flush[1])
import numpy as np

from speex_resampler_tpu.runtime import FleetResampler


def test_fleet_poll_max_launches():
    """poll(max_launches=N) runs at most N ready launches and leaves the
    rest staged; the banked output is identical to one unbounded poll."""
    rng = np.random.default_rng(31)
    S, C = 4, 1
    a = FleetResampler(S, C, 24000, 48000, 5, target_chunk_frames=300)
    b = FleetResampler(S, C, 24000, 48000, 5, target_chunk_frames=300)
    q = a.bspec.in_per_launch
    frames = (rng.integers(-20000, 20000, size=(S, 3 * q, C))
              ).astype(np.int16)
    for s in range(S):
        a.push(s, frames[s])
        b.push(s, frames[s])
    assert a.poll(max_launches=1) == 1
    assert int(a.staged().min()) == 2 * q      # two quanta still staged
    assert a.poll(max_launches=5) == 2         # capped by readiness
    assert b.poll() == 3
    for s in range(S):
        assert np.array_equal(a.pull(s), b.pull(s))


def test_fleet_pipeline_depth_output_invariant():
    """pipeline_depth changes only scheduling (launches in flight before
    the oldest readback), never output bytes or accounting: depths 1, 2
    and 4 must bank identical samples stream-for-stream, including
    through flush().  Guards the depth+1 slab ring — a slab refilled
    before its in-flight transfer completed would corrupt a launch."""
    rng = np.random.default_rng(41)
    S, C = 4, 2
    fleets = [FleetResampler(S, C, 44100, 48000, 7,
                             target_chunk_frames=1024,
                             pipeline_depth=d) for d in (1, 2, 4)]
    q = fleets[0].bspec.in_per_launch
    frames = (rng.integers(-32768, 32768, size=(S, 5 * q + 321, C))
              // 2).astype(np.int16)
    for f in fleets:
        for s in range(S):
            f.push(s, frames[s])
        f.poll()
        f.flush()
    for s in range(S):
        ref = fleets[0].pull(s)
        for f in fleets[1:]:
            assert np.array_equal(f.pull(s), ref)


def test_fleet_phase_stats_attribution():
    """Every poll attributes wall-clock to the four serving phases and
    the per-launch view divides by the launch count."""
    rng = np.random.default_rng(43)
    S, C = 2, 1
    fleet = FleetResampler(S, C, 24000, 48000, 5, target_chunk_frames=300)
    q = fleet.bspec.in_per_launch
    for s in range(S):
        fleet.push(s, (rng.integers(-20000, 20000, size=(2 * q, C))
                       ).astype(np.int16))
    assert fleet.poll() == 2
    st = fleet.stats
    for phase in ("gather", "dispatch", "readback", "unpack"):
        assert st.phase_seconds.get(phase, 0.0) > 0.0
        assert st.phase_ms_per_launch()[phase] == pytest.approx(
            st.phase_seconds[phase] * 1e3 / st.launches, abs=5e-5)
    assert st.launches == 2
    assert "phase_ms_per_launch" in st.as_dict()


def test_stager_boundary_validation_raises():
    """Shape/contiguity guards in front of the raw ctypes calls must
    RAISE (python -O strips asserts; an accepted bad shape would be an
    out-of-bounds memcpy in the C gather/scatter) — and raise the
    package's error taxonomy (ResamplerError/INVALID_ARG), so callers
    containing failures by catching ResamplerError also catch a
    mis-shaped push surfacing from a stager."""
    from speex_resampler_tpu.runtime.native import NativeStager, PyStager
    from speex_resampler_tpu.utils.errors import (ResamplerError,
                                                  ResamplerErrorCode)
    for st in (NativeStager(2, 2, 32), PyStager(2, 2, 32)):
        with pytest.raises(ResamplerError) as ei:
            st.push(0, np.zeros(64, dtype=np.int16))       # 1-D
        assert ei.value.code == ResamplerErrorCode.INVALID_ARG
        # the descriptive message rides the chained cause
        assert "frames must be" in str(ei.value.__cause__)
        with pytest.raises(ResamplerError):
            st.push(0, np.zeros((4, 3), dtype=np.int16))   # wrong C
    nat = NativeStager(2, 2, 32)
    with pytest.raises(ResamplerError):
        nat.fill_launch(out=np.zeros((8, 4), dtype=np.int16))   # short
    with pytest.raises(ResamplerError):
        nat.fill_launch_lm(np.zeros((4, 8), dtype=np.float32))  # dtype
    with pytest.raises(ResamplerError):
        nat.unpack_all_lm(np.zeros((4, 8), dtype=np.int16),
                          out=np.zeros((2, 8, 1), dtype=np.int16))


def test_stager_carry_size_matches_carry():
    """carry_size (the O(1) backpressure probe) always equals
    len(carry())."""
    from speex_resampler_tpu.runtime.native import NativeStager, PyStager
    for st in (NativeStager(1, 2, 16), PyStager(1, 2, 16)):
        assert st.carry_size(0) == 0
        st.push_bytes(0, b"\x01\x02\x03")      # 3 bytes: carry 3 (frame=4)
        assert st.carry_size(0) == len(st.carry(0)) == 3
        st.push_bytes(0, b"\x04\x05")          # completes a frame, carry 1
        assert st.carry_size(0) == len(st.carry(0)) == 1


def test_device_consumer_fleet():
    """device_consumer: the launch output is consumed ON DEVICE (fused
    into the jitted step) and readback transfers only the consumer's
    result (an on-device downstream consumer of the resampled audio).
    The checksum must equal the banked-path sum,
    pull() must yield nothing, and flush() must keep consuming."""
    import jax.numpy as jnp
    from speex_resampler_tpu.runtime.fleet import FleetResampler

    S, C = 8, 2
    fl = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=1024,
                        device_consumer=lambda y: jnp.sum(
                            y.astype(jnp.int32)))
    ref = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=1024)
    rng = np.random.default_rng(0)
    q = fl.bspec.in_per_launch
    frames = (rng.integers(-32768, 32768, size=(S, q, C)) // 2).astype(
        np.int16)
    for s in range(S):
        fl.push(s, frames[s])
        ref.push(s, frames[s])
    assert fl.poll() == 1 and ref.poll() == 1
    got = int(np.asarray(fl.consumed[0]))
    want = sum(int(ref.pull(s).astype(np.int32).sum()) for s in range(S))
    assert got == want
    assert fl.pull(0).shape == (0, C)        # audio never crossed to host
    assert fl.pending(0) == 0
    for s in range(S):                        # flush path consumes too
        fl.push(s, frames[s][:q // 2])
    fl.flush()
    assert len(fl.consumed) == 2
