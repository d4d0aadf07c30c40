"""Sub-quantum latency control (the voip preset's 20 ms budget).

The batch engine's launch quantum is also its availability latency: a
stream must stage in_per_launch frames before output appears (the
streaming role of src/index.ts:121-162).  ``max_latency_ms`` makes the
budget HARD: the quantum, normally rounded to the nearest multiple of
group*num frames, floors under the cap, and the group factor shrinks
when even one group stride is too long (min quantum = num frames, 3.3 ms
at 44.1k->48k).  Outputs are chunking-invariant, so the
low-latency engine is bit-identical to the default one — only WHEN output
becomes available changes.
"""

import numpy as np
import pytest

from speex_resampler_tpu.models.presets import get_preset
from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.runtime.fleet import FleetResampler
from speex_resampler_tpu.utils.errors import ResamplerError


def _random_frames(S, n, C, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(
        np.int16)


def test_voip_preset_quantum_under_budget():
    """The voip preset's engine kwargs produce a <= 20 ms launch quantum
    for the common rate pairs (the default 4096-frame target rounds the
    flagship to 93 ms)."""
    p = get_preset("voip")
    for ir, orr in [(44100, 48000), (48000, 44100), (24000, 48000),
                    (16000, 8000), (8000, 48000)]:
        eng = BatchedResampler(2, 1, ir, orr,
                               **p.engine_kwargs(ir))
        assert eng.launch_latency_ms <= 20.0 + 1e-9, (
            ir, orr, eng.launch_latency_ms)
        # the quantum stays a whole number of num-periods (f0-invariant)
        assert eng.in_frames_per_launch % eng.spec.num == 0


def test_low_latency_output_identical_to_default():
    """Chunking invariance: the 20 ms engine produces bit-identical
    output to the default (53 ms quantum) engine — only availability
    latency changes."""
    S, C = 2, 2
    frames = _random_frames(S, 12000, C, seed=3)
    fast = BatchedResampler(S, C, 44100, 48000, 7,
                            max_latency_ms=20.0)
    slow = BatchedResampler(S, C, 44100, 48000, 7)
    assert fast.launch_latency_ms <= 20.0
    assert slow.launch_latency_ms > 20.0  # the default rounds up
    a = np.concatenate([fast.process(frames), fast.flush()], axis=1)
    b = np.concatenate([slow.process(frames), slow.flush()], axis=1)
    assert np.array_equal(a, b)


def test_low_latency_availability():
    """Feeding exactly one 20 ms quantum must produce output immediately
    (the default engine would still be staging)."""
    S, C = 1, 1
    fast = BatchedResampler(S, C, 44100, 48000, 7,
                            max_latency_ms=20.0)
    q = fast.in_frames_per_launch
    assert q <= 882  # 20 ms at 44.1k
    y = fast.process(_random_frames(S, q, C, seed=5))
    assert y.shape[1] == fast.out_frames_per_launch > 0


def test_loose_budget_keeps_uncapped_geometry():
    """A budget looser than the natural quantum (4116 frames = 93 ms at
    the default target) keeps the uncapped geometry exactly."""
    plain = BatchedResampler(2, 1, 44100, 48000, 7)
    eng = BatchedResampler(2, 1, 44100, 48000, 7, max_latency_ms=100.0)
    assert eng.bspec == plain.bspec
    assert eng.launch_latency_ms <= 100.0


def test_infeasible_budget_raises():
    """Ratios whose single num-period exceeds the budget (44100->44101:
    num = 44100 frames = 1 s) cannot be served by f0-invariant batching;
    the engine must refuse rather than silently violate the budget (the
    single-stream ResamplerCore covers true sample-level latency)."""
    with pytest.raises(ResamplerError):
        BatchedResampler(2, 1, 44100, 44101, 1,
                         max_latency_ms=20.0)


def test_fleet_low_latency():
    """FleetResampler honors the hard budget: a stream that stages 20 ms
    of audio gets output on the next poll."""
    S, C = 3, 2
    fleet = FleetResampler(S, C, 44100, 48000, 7,
                           max_latency_ms=20.0)
    assert fleet.launch_latency_ms <= 20.0
    q = fleet.bspec.in_per_launch
    frames = _random_frames(S, q, C, seed=11)
    for s in range(S):
        fleet.push(s, frames[s])
    assert fleet.poll() == 1
    for s in range(S):
        assert fleet.pending(s) == fleet.bspec.out_per_launch


def test_multifleet_low_latency():
    """MultiFleet forwards the hard budget to every bucket's fleet."""
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    mf = MultiFleet(1, capacity_per_bucket=4,
                    max_latency_ms=20.0)
    mf.add_stream("a", 44100, 48000, 7)
    mf.add_stream("b", 24000, 48000, 5)
    for b in mf._buckets.values():
        assert b.fleet.launch_latency_ms <= 20.0


def test_permissive_budget_never_inflates_quantum():
    """A cap looser than the chosen geometry must be a no-op: same
    quantum as the uncapped engine (a cap may only ever shrink)."""
    plain = BatchedResampler(2, 1, 44100, 48000, 7,
                             target_chunk_frames=882)
    capped = BatchedResampler(2, 1, 44100, 48000, 7,
                              target_chunk_frames=882,
                              max_latency_ms=1000.0)
    assert capped.in_frames_per_launch == plain.in_frames_per_launch


def test_budget_holds_when_rounding_overflows():
    """A cap of 960 frames rounds to 7 flagship periods (1029 frames) —
    over the cap — so the quantum must floor to 6 periods instead."""
    eng = BatchedResampler(2, 1, 44100, 48000, 7, target_chunk_frames=9408,
                           max_latency_ms=960 / 44.1)
    assert eng.bspec.kernel == "dense"
    assert eng.in_frames_per_launch == 6 * 147
    assert eng.launch_latency_ms <= 960 / 44.1


def test_budget_below_one_group_shrinks_group():
    """24k->48k (num 1, den 2) batches 64 periods per GEMM row; a 1 ms cap
    (24 frames) is shorter than that stride, so the group factor shrinks
    to fit, and the output is unchanged."""
    plain = BatchedResampler(2, 1, 24000, 48000, 5)
    eng = BatchedResampler(2, 1, 24000, 48000, 5, max_latency_ms=1.0)
    assert eng.bspec.kernel == "dense"
    assert eng.bspec.group < plain.bspec.group
    assert eng.in_frames_per_launch <= 24
    frames = _random_frames(2, 3000, 1, seed=12)
    a = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    b = np.concatenate([plain.process(frames), plain.flush()], axis=1)
    from conftest import assert_lsb_close
    assert_lsb_close(a.ravel(), b.ravel())


def test_latency_cap_huge_den_dense_fallback_routes_to_gather():
    """A huge-den spec whose padded L x group*den matrix would bust
    MAX_PADDED_WEIGHT_BYTES must stay on the weight-free gather geometry
    under a cap, floor-quantized to whole num-periods within it."""
    from speex_resampler_tpu.ops import filter_design as fd
    from speex_resampler_tpu.parallel.batch import _launch_geometry

    spec = fd.design_filter(513, 16384, 0)
    un = _launch_geometry(spec, 4096)
    assert un.kernel == "gather"
    capped = _launch_geometry(spec, 4096, max_in_frames=1000)
    assert capped.kernel == "gather", capped.kernel
    assert capped.n_blocks * spec.num <= 1000


def test_fuzz_latency_caps_random_configs():
    """Seeded sweep: for random (ratio, quality, cap) draws the capped
    engine must (a) keep its quantum under the cap or refuse cleanly when
    one period can't fit, and (b) match the uncapped engine to <= 1 LSB
    (a different launch quantum reshapes the dense matmul, so XLA may
    regroup the f32 accumulation — rounding-boundary ties only; see
    tests/test_batch.py module docstring) — hardening the round-3
    geometry wrapper beyond the hand-picked configs."""
    import math
    from conftest import assert_lsb_close

    rates = [8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000]
    rng = np.random.default_rng(404)
    checked = 0
    while checked < 8:
        ir, orr = (int(r) for r in rng.choice(rates, size=2, replace=False))
        q = int(rng.integers(0, 11))
        cap_ms = float(rng.choice([5.0, 20.0, 60.0, 250.0]))
        num = ir // math.gcd(ir, orr)
        try:
            capped = BatchedResampler(2, 1, ir, orr, q,
                                      max_latency_ms=cap_ms)
        except ResamplerError:
            # legal only when one num-period exceeds the cap
            assert num > cap_ms * ir / 1000, (ir, orr, q, cap_ms)
            continue
        assert capped.launch_latency_ms <= cap_ms + 1e-9, (
            ir, orr, q, cap_ms, capped.launch_latency_ms)
        assert capped.in_frames_per_launch % num == 0
        plain = BatchedResampler(2, 1, ir, orr, q)
        frames = _random_frames(2, 9000, 1, seed=checked)
        a = np.concatenate([capped.process(frames), capped.flush()], axis=1)
        b = np.concatenate([plain.process(frames), plain.flush()], axis=1)
        assert_lsb_close(a, b)
        checked += 1
