"""Engine-level zero-fill degradation (fleet-scale failure path).

The reference degrades to the zero-output resampler on alloc failure so
callers ignoring error codes can't deadlock: resampler_basic_zero emits
zeros while advancing state identically (resample.c:561-591), installed by
the fn-ptr swap at :785-791.  At 1024-stream scale the analogous failure is
a device fault inside a launch; these tests inject faults at both failure
surfaces (synchronous dispatch and async readback) and assert the engines
keep consuming/producing the EXACT sample counts — all zeros — with
staging/history state consistent, like the C core.
"""

import dataclasses

import numpy as np
import pytest

from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.runtime.fleet import FleetResampler
from speex_resampler_tpu.utils.errors import ResamplerError


def _random_frames(S, n, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(
        np.int16)


def _poison_dispatch(eng):
    """Make the next device dispatch raise (synchronous failure)."""
    def boom(*a, **k):
        raise RuntimeError("injected device fault")
    eng._step = dataclasses.replace(eng._step, fn=boom)


class _FailsOnReadback:
    """A fake dispatched result whose readback raises — the async failure
    surface (XLA device errors often surface at block_until_ready,
    not at dispatch)."""

    def block_until_ready(self):
        raise RuntimeError("injected async device fault")


def _poison_readback(eng):
    real_rows = eng._step.hist_rows

    def fake(hist, x, w):
        # dispatch "succeeds"; both results poison their consumers
        return _FailsOnReadback(), _FailsOnReadback()

    eng._step = dataclasses.replace(eng._step, fn=fake)
    return real_rows


@pytest.mark.parametrize("fail_mode", ["dispatch", "readback"])
def test_batched_degrades_with_exact_accounting(fail_mode):
    S, C = 2, 2
    frames = _random_frames(S, 9000, C, seed=3)
    healthy = BatchedResampler(S, C, 44100, 48000, 7,
                               target_chunk_frames=1024)
    eng = BatchedResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)

    a1 = healthy.process(frames[:, :4000])
    b1 = eng.process(frames[:, :4000])
    assert np.array_equal(a1, b1) and not eng.degraded

    if fail_mode == "dispatch":
        _poison_dispatch(eng)
    else:
        _poison_readback(eng)

    a2 = healthy.process(frames[:, 4000:])
    b2 = eng.process(frames[:, 4000:])
    assert eng.degraded
    # exact accounting: same output shape as the healthy engine, all zeros
    assert b2.shape == a2.shape
    assert not b2.any()

    # the engine must keep serving (consume/produce exact counts) forever
    a3 = healthy.process(frames[:, :4000])
    b3 = eng.process(frames[:, :4000])
    assert b3.shape == a3.shape and not b3.any()

    af = healthy.flush()
    bf = eng.flush()
    assert bf.shape == af.shape and not bf.any()


def test_batched_degraded_mid_pipeline_counts():
    """Failure after some launches already dispatched in the same process()
    call: total output count still exact (healthy prefix + zero suffix)."""
    S, C = 1, 1
    frames = _random_frames(S, 40000, C, seed=9)
    healthy = BatchedResampler(S, C, 24000, 48000, 5,
                               target_chunk_frames=512)
    eng = BatchedResampler(S, C, 24000, 48000, 5,
                           target_chunk_frames=512)
    q = eng.in_frames_per_launch

    calls = {"n": 0}
    real_fn = eng._step.fn

    def flaky(hist, x, w):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected fault on launch 3")
        return real_fn(hist, x, w)

    eng._step = dataclasses.replace(eng._step, fn=flaky)

    a = np.concatenate([healthy.process(frames), healthy.flush()], axis=1)
    b = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    assert eng.degraded
    assert b.shape == a.shape
    # launches 1-2 are healthy and bit-identical; everything after is zero
    n_good = 2 * eng.out_frames_per_launch
    assert np.array_equal(b[:, :n_good], a[:, :n_good])
    assert not b[:, n_good:].any()
    assert calls["n"] == 3  # the poisoned step is never called again


def test_batched_degraded_sticky_and_control_paths():
    """reset_mem / skip_zeros / checkpoint survive degradation; like the C
    core, reset_mem does NOT un-degrade (resample.c:1208-1220 never
    reinstalls resampler_ptr)."""
    S, C = 1, 2
    frames = _random_frames(S, 6000, C, seed=13)
    eng = BatchedResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)
    eng.process(frames)
    _poison_dispatch(eng)
    eng.process(frames)
    assert eng.degraded

    eng.reset_mem()
    assert eng.degraded
    eng.skip_zeros()
    y = eng.process(frames)
    assert y.shape[1] % eng.out_frames_per_launch == 0
    assert not y.any()

    # checkpoint round-trip preserves the degraded mode and keeps serving
    state = eng.state_dict()
    assert state["degraded"]
    eng2 = BatchedResampler(S, C, 44100, 48000, 7,
                            target_chunk_frames=1024)
    eng2.load_state_dict(state)
    assert eng2.degraded
    y2 = np.concatenate([eng2.process(frames), eng2.flush()], axis=1)
    assert not y2.any()


@pytest.mark.parametrize("fail_mode", ["dispatch", "readback"])
def test_fleet_degrades_mid_serving(fail_mode):
    """Kill the device step mid-serving on a ragged fleet: poll()/flush()
    keep draining the exact per-stream counts (zeros), nothing deadlocks,
    push/pull stay usable."""
    S, C = 3, 2
    fleet = FleetResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)
    healthy = FleetResampler(S, C, 44100, 48000, 7,
                             target_chunk_frames=1024)
    frames = _random_frames(S, 5000, C, seed=21)

    for s in range(S):
        fleet.push(s, frames[s, :3000])
        healthy.push(s, frames[s, :3000])
    n_healthy_launches = fleet.poll()
    healthy.poll()

    if fail_mode == "dispatch":
        _poison_dispatch(fleet)
    else:
        _poison_readback(fleet)

    for s in range(S):
        fleet.push(s, frames[s, 3000:])
        healthy.push(s, frames[s, 3000:])
    fleet.poll()
    healthy.poll()
    assert fleet.degraded
    mid_state = fleet.state_dict()   # degraded, NOT yet flushed
    fleet.flush()
    healthy.flush()

    ref0 = None
    for s in range(S):
        got = fleet.pull(s)
        ref = healthy.pull(s)
        assert got.shape == ref.shape
        # pre-failure launches are healthy and identical; the rest zero
        n_good = n_healthy_launches * fleet.bspec.out_per_launch
        assert np.array_equal(got[:n_good], ref[:n_good])
        assert not got[n_good:].any()
        if s == 0:
            ref0 = ref

    # checkpoint round-trip preserves degradation AND terminal flush
    state = fleet.state_dict()
    assert state["degraded"]
    f2 = FleetResampler(S, C, 44100, 48000, 7,
                        target_chunk_frames=1024)
    f2.load_state_dict(state)
    assert f2.degraded
    with pytest.raises(ResamplerError):
        f2.push(0, frames[0])        # flush is terminal, survives restore

    # a degraded snapshot taken MID-SERVING stays fully serviceable:
    # restoring it keeps draining the exact per-stream counts, as zeros
    f3 = FleetResampler(S, C, 44100, 48000, 7,
                        target_chunk_frames=1024)
    f3.load_state_dict(mid_state)
    assert f3.degraded
    for s in range(S):
        f3.push(s, frames[s, :2000])
    f3.poll()
    f3.flush()
    got3 = f3.pull(0)
    n_good = n_healthy_launches * fleet.bspec.out_per_launch
    assert got3.shape[0] > n_good
    assert np.array_equal(got3[:n_good], ref0[:n_good])
    assert not got3[n_good:].any()


def test_multifleet_degraded_surface():
    """MultiFleet surfaces per-bucket degradation; a poisoned bucket keeps
    draining exact zero counts while healthy buckets stay bit-correct."""
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    mf = MultiFleet(1, capacity_per_bucket=4, target_chunk_frames=1024)
    mf.add_stream("a", 44100, 48000, 7)
    mf.add_stream("b", 24000, 48000, 5)
    frames = _random_frames(1, 4000, 1, seed=33)[0]
    mf.push("a", frames)
    mf.push("b", frames)
    mf.poll()
    assert not mf.degraded

    # poison only the 44.1k bucket's fleet
    for key, bucket in mf._buckets.items():
        if 44100 in key if isinstance(key, tuple) else "44100" in str(key):
            _poison_dispatch(bucket.fleet)
    mf.push("a", frames)
    mf.push("b", frames)
    mf.poll()
    assert mf.degraded
    assert any(mf.degraded_buckets().values())
    # the healthy bucket still produces real (nonzero) output
    assert mf.pull("b").any()


def test_fleet_healthy_checkpoint_into_degraded_fleet():
    """Restoring a PRE-failure (healthy) checkpoint into an
    already-degraded fleet must keep the degraded host-state invariants:
    degradation is sticky and slot ops must not hit an immutable device
    array (round-3 review finding)."""
    S, C = 2, 1
    fleet = FleetResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)
    frames = _random_frames(S, 3000, C, seed=44)
    for s in range(S):
        fleet.push(s, frames[s])
    fleet.poll()
    healthy_state = fleet.state_dict()
    assert not healthy_state["degraded"]

    _poison_dispatch(fleet)
    for s in range(S):
        fleet.push(s, frames[s])
    fleet.poll()
    assert fleet.degraded

    fleet.load_state_dict(healthy_state)
    assert fleet.degraded  # sticky
    # slot ops on the (host) hist must work, not raise on a jnp array
    fleet.clear_slot(0)
    fleet.seed_lane_history(0, np.zeros((fleet.spec.filt_len - 1, C),
                                        np.int16))
    for s in range(S):
        fleet.push(s, frames[s])
    fleet.poll()
    fleet.flush()
    assert not fleet.pull(0).any()


def test_batched_flush_after_async_death_degrades():
    """A device failure surfacing only at a control-path readback
    (flush/skip_zeros reading the history) must degrade, not raise."""
    S, C = 1, 1
    eng = BatchedResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=1024)
    eng.process(_random_frames(S, 2000, C, seed=47))

    class _DeadHist:
        shape = (eng._step.hist_rows, eng.B)

        def block_until_ready(self):
            raise RuntimeError("device died")

    eng._hist = _DeadHist()
    y = eng.flush()  # must not raise
    assert eng.degraded
    assert not y.any()


def _uncompilable(real):
    """make_batched_step whose step cannot be lowered (a shape error
    inside the jitted function, the way a device compiler refusal would
    surface at the first launch)."""
    import jax

    def make(spec, bspec, **kw):
        step = real(spec, bspec, **kw)
        return dataclasses.replace(
            step, fn=jax.jit(lambda hist, x, w: (hist, hist @ hist)))
    return make


@pytest.mark.parametrize("front", ["batched", "fleet", "multifleet"])
def test_step_that_fails_to_compile_raises_at_construction(front,
                                                           monkeypatch):
    """A step that fails to compile raises ResamplerError(ALLOC_FAILED)
    from the engine's constructor — it must not degrade the engine into
    permanent zero output at its first launch."""
    import speex_resampler_tpu.parallel.batch as batch_mod
    import speex_resampler_tpu.runtime.fleet as fleet_mod
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    from speex_resampler_tpu.utils.errors import ResamplerErrorCode
    for mod in (batch_mod, fleet_mod):
        monkeypatch.setattr(mod, "make_batched_step",
                            _uncompilable(batch_mod.make_batched_step))
    with pytest.raises(ResamplerError) as err:
        if front == "batched":
            BatchedResampler(2, 2, 44100, 48000, 7)
        elif front == "fleet":
            FleetResampler(2, 2, 44100, 48000, 7)
        else:
            mf = MultiFleet(channels=2, capacity_per_bucket=2)
            try:
                mf.add_stream("s", 44100, 48000, 7)
            finally:
                assert not mf._buckets    # no half-built bucket kept
    assert err.value.code == ResamplerErrorCode.ALLOC_FAILED
