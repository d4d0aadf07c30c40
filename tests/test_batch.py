"""Batched multi-stream engine parity and sharding tests.

The contract (the batched serving deployment): a batch of S streams
produces, per stream, the same samples as S independent single-stream
resamplers — which are themselves golden-tested against the C oracle in
test_golden.py.  Comparisons allow the 1-LSB rounding-tie bound
(conftest.assert_lsb_close), since launch-quantum chunking regroups the f32
accumulation.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from speex_resampler_tpu.core.resampler import ResamplerCore
from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.ops import filter_design as fd

from conftest import assert_lsb_close


def _random_frames(S, n, C, seed=0):
    rng = np.random.default_rng(seed)
    # music-scale PCM, keeps outputs clear of the saturation clamp
    return (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(np.int16)


def _core_reference(frames, in_rate, out_rate, quality):
    """Per-stream single-core outputs (golden-tested path)."""
    S = frames.shape[0]
    outs = []
    for s in range(S):
        core = ResamplerCore(frames.shape[2], in_rate, out_rate, in_rate,
                             out_rate, quality)
        outs.append(core.process_interleaved(frames[s], 10**9))
    n = min(o.shape[0] for o in outs)
    return np.stack([o[:n] for o in outs])


def _assert_matches_core(eng, frames, in_rate, out_rate, quality):
    """Whole-stream engine output (process + flush) vs the per-stream
    single-core reference."""
    got = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    ref = _core_reference(frames, in_rate, out_rate, quality)
    m = min(got.shape[1], ref.shape[1])
    assert m > 0 and abs(got.shape[1] - ref.shape[1]) <= 1
    assert_lsb_close(got[:, :m].ravel(), ref[:, :m].ravel())


@pytest.mark.parametrize("in_rate,out_rate,quality", [
    (44100, 48000, 7),    # interpolated path, the flagship config
    (24000, 48000, 5),    # direct path, integer upsample
    (44100, 24000, 5),    # downsampling
])
def test_batched_matches_single_stream(in_rate, out_rate, quality):
    S, C, n = 3, 2, 9000
    frames = _random_frames(S, n, C, seed=quality)
    eng = BatchedResampler(S, C, in_rate, out_rate, quality,
                           target_chunk_frames=1024)
    out = eng.process(frames)
    tail = eng.flush()
    full = np.concatenate([out, tail], axis=1)
    ref = _core_reference(frames, in_rate, out_rate, quality)
    m = min(full.shape[1], ref.shape[1])
    assert abs(full.shape[1] - ref.shape[1]) <= 1
    assert_lsb_close(full[:, :m].ravel(), ref[:, :m].ravel())


def test_batched_chunking_invariance():
    """Feeding tiny irregular chunks == feeding everything at once."""
    S, C = 2, 1
    frames = _random_frames(S, 7000, C, seed=3)
    eng1 = BatchedResampler(S, C, 44100, 48000, 7)
    a = np.concatenate([eng1.process(frames), eng1.flush()], axis=1)

    eng2 = BatchedResampler(S, C, 44100, 48000, 7)
    outs, pos = [], 0
    rng = np.random.default_rng(0)
    while pos < frames.shape[1]:
        step = int(rng.integers(1, 997))
        outs.append(eng2.process(frames[:, pos:pos + step]))
        pos += step
    outs.append(eng2.flush())
    b = np.concatenate(outs, axis=1)
    assert np.array_equal(a, b)


def test_batched_skip_zeros_matches_core():
    S, C = 2, 1
    frames = _random_frames(S, 6000, C, seed=4)
    eng = BatchedResampler(S, C, 24000, 48000, 5,
                           target_chunk_frames=512)
    eng.skip_zeros()
    full = np.concatenate([eng.process(frames), eng.flush()], axis=1)

    outs = []
    for s in range(S):
        core = ResamplerCore(C, 24000, 48000, 24000, 48000, 5)
        core.skip_zeros()
        outs.append(core.process_interleaved(frames[s], 10**9))
    n = min(o.shape[0] for o in outs)
    ref = np.stack([o[:n] for o in outs])
    m = min(full.shape[1], ref.shape[1])
    assert m > 0
    assert_lsb_close(full[:, :m].ravel(), ref[:, :m].ravel())


def test_batched_reset_mem():
    S, C = 2, 2
    frames = _random_frames(S, 5000, C, seed=5)
    eng = BatchedResampler(S, C, 44100, 48000, 7)
    a = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    eng.reset_mem()
    b = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    assert np.array_equal(a, b)


def test_batched_mesh_sharded_matches_unsharded():
    """Lane axis sharded over an 8-device CPU mesh == single-device run."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    S, C = 8, 2
    frames = _random_frames(S, 6000, C, seed=7)

    plain = BatchedResampler(S, C, 44100, 48000, 7)
    a = np.concatenate([plain.process(frames), plain.flush()], axis=1)

    sharded = BatchedResampler(S, C, 44100, 48000, 7,
                               mesh=mesh)
    b = np.concatenate([sharded.process(frames), sharded.flush()], axis=1)
    assert np.array_equal(a, b)


def test_batched_mesh_sharded_fixed_matches_unsharded():
    """The FIXED_POINT dense step (exact int8-plane dots) under shard_map
    on an 8-device CPU mesh is bit-equal to the unsharded run, and both
    equal the exact host fixed loops."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    S, C = 8, 2
    frames = _random_frames(S, 6000, C, seed=11)

    plain = BatchedResampler(S, C, 44100, 48000, 7, fixed_point=True)
    a = np.concatenate([plain.process(frames), plain.flush()], axis=1)

    sharded = BatchedResampler(S, C, 44100, 48000, 7, fixed_point=True,
                               mesh=mesh)
    b = np.concatenate([sharded.process(frames), sharded.flush()], axis=1)
    assert np.array_equal(a, b)
    core = ResamplerCore(C, 44100, 48000, 44100, 48000, 7, fixed_point=True)
    ref = core.process_interleaved(frames[0], 10**9)
    assert np.array_equal(a[0, :len(ref)], ref)


@pytest.mark.parametrize("fixed", [False, True])
def test_batched_mesh_sharded_gather_geometry(fixed):
    """The gather geometry (pathological huge-den ratios, 44100->44101)
    under an 8-device mesh: plain jnp, so shard_map splits the lane axis
    with replicated (taps, starts[, coef]) (round-3 review item: this was
    the one config family refusing mesh=).

    Equality contract matches the universes: FIXED is bit-identical under
    any resharding (wrapping int32 accumulation is order-free); FLOAT
    holds the repo-wide <=1 LSB / rare-ties bound (the per-shard batch
    width changes the einsum's compiled f32 accumulation grouping —
    measured 49 rounding-boundary ties over 368k samples on the CPU
    backend, max |err| 1)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    S, C = 8, 1
    frames = _random_frames(S, 46000, C, seed=13)

    plain = BatchedResampler(S, C, 44100, 44101, 1,
                             target_chunk_frames=44100, fixed_point=fixed)
    assert plain.bspec.kernel == "gather"
    a = np.concatenate([plain.process(frames), plain.flush()], axis=1)

    sharded = BatchedResampler(S, C, 44100, 44101, 1,
                               target_chunk_frames=44100,
                               fixed_point=fixed, mesh=mesh)
    assert sharded.bspec.kernel == "gather"
    b = np.concatenate([sharded.process(frames), sharded.flush()], axis=1)
    if fixed:
        assert np.array_equal(a, b)
    else:
        assert_lsb_close(a.ravel(), b.ravel(), max_mismatch_rate=1e-3)


@pytest.mark.parametrize("in_rate,out_rate,quality", [
    (8000, 48000, 2),     # 1/6 integer upsample (group > 1)
    (48000, 8000, 4),     # 6/1 decimation (6x longer filter)
    (32000, 44100, 8),    # 320/441 large-den interpolated
])
def test_batched_extreme_ratios(in_rate, out_rate, quality):
    """The dense geometry (group factor, patch views, padded weights)
    across ratio extremes, engine vs the single-stream core."""
    S, C = 2, 1
    frames = _random_frames(S, 6000, C, seed=quality)
    eng = BatchedResampler(S, C, in_rate, out_rate, quality,
                           target_chunk_frames=1024)
    _assert_matches_core(eng, frames, in_rate, out_rate, quality)


def test_batched_long_cycle_q10():
    """48k->44.1k q10 (den 147, a 256-tap double-accumulator filter over a
    147-phase weight cycle) through the dense step, engine vs core."""
    S, C = 2, 1
    frames = _random_frames(S, 45000, C, seed=13)
    eng = BatchedResampler(S, C, 48000, 44100, 10)
    assert eng.bspec.kernel == "dense"
    _assert_matches_core(eng, frames, 48000, 44100, 10)


def test_small_quantum_history_carry():
    """Launch quantum smaller than the history window (n_in < hist_rows):
    the next history must splice surviving old history with the new chunk,
    not slice past the chunk's start (silent filter-state corruption,
    ~27k LSB error, when it did)."""
    S, C = 1, 1
    frames = _random_frames(S, 4000, C, seed=21)
    eng = BatchedResampler(S, C, 100, 44100, 10, target_chunk_frames=128)
    assert eng.bspec.in_per_launch < eng._step.hist_rows  # the bug trigger
    _assert_matches_core(eng, frames, 100, 44100, 10)


def test_small_quantum_history_carry_upsample():
    """Same n_in < hist_rows trigger at a 1/64 upsample with a long Q10
    filter: the minimum launch quantum (16 frames) is far below the
    255-row history window."""
    S, C = 2, 1
    frames = _random_frames(S, 600, C, seed=22)
    eng = BatchedResampler(S, C, 1000, 64000, 10, target_chunk_frames=16)
    assert eng.bspec.in_per_launch < eng._step.hist_rows
    _assert_matches_core(eng, frames, 1000, 64000, 10)


def _skip_anytime_oracle(oracle, tmp_path, in_rate, out_rate, q, tag):
    """Engine vs the oracle through the same chunk schedule with a
    mid-stream skip_zeros.  Only bind-free ratios qualify: the JS capacity
    rule floor(ceil(2n*r)/2) can fall one frame short of the producible
    count for fractional r, making the oracle drop input the engine never
    sees (that quirk is pinned separately by
    test_capacity_grows_monotonically_like_js)."""
    import subprocess
    rng = np.random.default_rng(41)
    n = 30000
    pcm = (rng.integers(-32768, 32768, size=n) // 2).astype("<i2")
    chunk_a = 7000  # NOT a multiple of any launch quantum

    inp = tmp_path / f"in{tag}.pcm"
    outp = tmp_path / f"out{tag}.pcm"
    sched = tmp_path / f"s{tag}.txt"
    inp.write_bytes(pcm.tobytes())
    sched.write_text(f"{chunk_a}\n{n - chunk_a}\n")
    subprocess.run([str(oracle), "chunks", "1", str(in_rate), str(out_rate),
                    str(q), str(inp), str(outp), str(sched), "1"],
                   check=True)
    want = np.fromfile(outp, dtype=np.int16)
    got = _engine_skip_run(pcm, in_rate, out_rate, q)
    m = min(got.shape[0], want.shape[0])
    assert abs(got.shape[0] - want.shape[0]) <= 1, (got.shape, want.shape)
    assert_lsb_close(got[:m], want[:m])


def _engine_skip_run(pcm, in_rate, out_rate, q, chunk_a=7000):
    eng = BatchedResampler(1, 1, in_rate, out_rate, q)
    frames = pcm.reshape(1, -1, 1)
    parts = [eng.process(frames[:, :chunk_a])]
    eng.skip_zeros()                      # staged remainder drains exactly
    parts.append(eng.process(frames[:, chunk_a:]))
    parts.append(eng.flush())
    return np.concatenate(parts, axis=1).ravel()


def _core_skip_run(pcm, in_rate, out_rate, q, chunk_a=7000):
    core = ResamplerCore(1, in_rate, out_rate, in_rate, out_rate, q)
    p1 = core.process_interleaved(pcm[:chunk_a].reshape(-1, 1), 10 ** 9)
    core.skip_zeros()
    p2 = core.process_interleaved(pcm[chunk_a:].reshape(-1, 1), 10 ** 9)
    return np.concatenate([p1, p2]).ravel()


def test_batched_skip_zeros_anytime(oracle, tmp_path):
    """C allows skip_zeros at any point (resample.c:1200-1206); the engine
    drains the staged remainder exactly, applies the origin jump, and
    continues — oracle-pinned on a bind-free ratio, core-pinned (the core
    mirrors C's last_sample = filt_len/2 line-for-line and is itself
    oracle-golden) on fractional ratios that exercise the f0 rebuild."""
    _skip_anytime_oracle(oracle, tmp_path, 24000, 48000, 5, "a")
    rng = np.random.default_rng(43)
    pcm = (rng.integers(-32768, 32768, size=30000) // 2).astype(np.int16)
    for (ir, orr, q) in [(44100, 48000, 7), (44100, 24000, 5)]:
        got = _engine_skip_run(pcm, ir, orr, q)
        want = _core_skip_run(pcm, ir, orr, q)
        m = min(got.shape[0], want.shape[0])
        assert abs(got.shape[0] - want.shape[0]) <= 1
        assert_lsb_close(got[:m], want[:m])


@pytest.mark.parametrize("in_rate,out_rate,quality", [
    (44100, 48000, 7), (44100, 24000, 5)])
def test_batched_skip_zeros_anytime_matches_core(in_rate, out_rate,
                                                 quality):
    """Mid-stream skip_zeros on fractional ratios: the drained remainder
    rebuilds the step at a new phase f0, whose weights must be right —
    engine vs the single-stream core driven through the same calls."""
    rng = np.random.default_rng(44)
    pcm = (rng.integers(-32768, 32768, size=30000) // 2).astype(np.int16)
    got = _engine_skip_run(pcm, in_rate, out_rate, quality)
    want = _core_skip_run(pcm, in_rate, out_rate, quality)
    m = min(got.shape[0], want.shape[0])
    assert abs(got.shape[0] - want.shape[0]) <= 1
    assert_lsb_close(got[:m], want[:m])


def test_batched_accepts_strided_views():
    """NumPy strided views subsume the C stride API (see class docstring):
    feeding a non-contiguous view equals feeding its contiguous copy."""
    S, C = 2, 2
    wide = _random_frames(S, 4000, 2 * C, seed=51)   # 4-channel recording
    view = wide[:, :, ::2]                           # channels 0 and 2
    assert not view.flags["C_CONTIGUOUS"]

    a_eng = BatchedResampler(S, C, 44100, 48000, 7)
    a = np.concatenate([a_eng.process(view), a_eng.flush()], axis=1)
    b_eng = BatchedResampler(S, C, 44100, 48000, 7)
    b = np.concatenate([b_eng.process(np.ascontiguousarray(view)),
                        b_eng.flush()], axis=1)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("in_rate,out_rate,quality", [
    (24000, 48000, 5),    # direct path, group > 1
    (48000, 44100, 10),   # long weight cycle, double accumulator
])
def test_batched_mesh_sharded_families(in_rate, out_rate, quality):
    """Other dense geometries under an 8-device mesh equal the unsharded
    run (lanes are share-nothing; the weights ride replicated)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    S, C = 8, 1
    frames = _random_frames(S, 12000, C, seed=81)

    plain = BatchedResampler(S, C, in_rate, out_rate, quality)
    a = np.concatenate([plain.process(frames), plain.flush()], axis=1)
    sharded = BatchedResampler(S, C, in_rate, out_rate, quality, mesh=mesh)
    b = np.concatenate([sharded.process(frames), sharded.flush()], axis=1)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("fixed", [False, True])
def test_batched_random_config_fuzz(fixed):
    """Seeded sweep over random (ratio, quality) configs: the batched
    engine must match the single-stream core on every one — hardens the
    dense geometry machinery (group factor, patch views, weight padding,
    phase origin) beyond the hand-picked matrix."""
    rng = np.random.default_rng(2024 + fixed)
    rates = [8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200]
    for tried in range(8):
        ir, orr = (int(r) for r in rng.choice(rates, size=2,
                                              replace=False))
        q = int(rng.integers(0, 11))
        S, C = 2, 1
        n = 12000 if max(ir, orr) / min(ir, orr) < 4 else 30000
        frames = _random_frames(S, n, C, seed=tried)
        eng = BatchedResampler(S, C, ir, orr, q, fixed_point=fixed)
        got = np.concatenate([eng.process(frames), eng.flush()], axis=1)
        for s in range(S):
            core = ResamplerCore(C, ir, orr, ir, orr, q, fixed_point=fixed)
            ref = core.process_interleaved(frames[s], 10**9)
            m = min(got.shape[1], len(ref))
            assert abs(got.shape[1] - len(ref)) <= 1, (ir, orr, q)
            if fixed:
                assert np.array_equal(got[s, :m], ref[:m]), (ir, orr, q)
            else:
                assert_lsb_close(got[s, :m].ravel(), ref[:m].ravel())


@pytest.mark.parametrize("fixed", [False, True])
def test_batched_gather_pathological_ratio(fixed):
    """Huge-den coprime ratios (44100->44101) must not build GB weight
    matrices: the engine falls to the weight-free gather geometry (the
    dense weight size is computed, never built).  Launch quantum is
    one num-block (~1 s of audio — inherent to f0-invariant batching at
    such ratios)."""
    S, C, n = 2, 1, 95000
    frames = _random_frames(S, n, C, seed=5)
    eng = BatchedResampler(S, C, 44100, 44101, 1,
                           target_chunk_frames=44100, fixed_point=fixed)
    assert eng.bspec.kernel == "gather"
    y = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    from speex_resampler_tpu.core.resampler import ResamplerCore
    for s in range(S):
        core = ResamplerCore(C, 44100, 44101, 44100, 44101, 1,
                             fixed_point=fixed)
        ref = core.process_interleaved(frames[s], 10 ** 9)
        m = min(y.shape[1], len(ref))
        assert abs(y.shape[1] - len(ref)) <= 1
        if fixed:
            assert np.array_equal(y[s, :m], ref[:m])
        else:
            assert_lsb_close(y[s, :m].ravel(), ref[:m].ravel())


def test_batched_mesh_sharded_flagship_quantum():
    """The flagship launch quantum (9408 in-frames -> 10240 out-frames)
    under an 8-device mesh: sharded output equals the unsharded run and
    the lane axis stays sharded on the step's outputs."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    S, C = 8, 1
    frames = _random_frames(S, 2 * 9408 + 100, C, seed=91)

    plain = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=9408)
    assert plain.in_frames_per_launch == 9408
    a = np.concatenate([plain.process(frames), plain.flush()], axis=1)
    sharded = BatchedResampler(S, C, 44100, 48000, 7,
                               target_chunk_frames=9408, mesh=mesh)
    b = np.concatenate([sharded.process(frames), sharded.flush()], axis=1)
    assert np.array_equal(a, b)
    x = sharded._on_lanes(jnp.zeros((sharded._step.chunk_rows, S * C),
                                    jnp.int16))
    h2, y = sharded._step.fn(sharded._hist, x, sharded._w)
    assert len(y.sharding.device_set) == 8
    assert len(h2.sharding.device_set) == 8


def test_step_cache_reuses_identical_config():
    """make_batched_step memoizes: an identical (design, geometry, knobs)
    request returns the SAME BatchedStep — a MultiFleet bucket rebuilt
    after idle-LRU eviction must not pay a second XLA trace/compile.
    Different geometry or layout must miss."""
    import speex_resampler_tpu.parallel.batch as batch_mod

    batch_mod.clear_step_cache()
    spec = fd.design_filter(147, 160, 7)
    bspec = batch_mod._launch_geometry(spec, 4096)
    s1 = batch_mod.make_batched_step(spec, bspec)
    # a FRESH spec object with the same design identity still hits
    spec2 = fd.design_filter(147, 160, 7)
    s2 = batch_mod.make_batched_step(spec2, bspec)
    assert s1 is s2
    # different launch geometry misses
    bspec3 = batch_mod._launch_geometry(spec, 8192)
    if bspec3 != bspec:
        s3 = batch_mod.make_batched_step(spec, bspec3)
        assert s3 is not s1
    # lane-major trace is a different step
    s4 = batch_mod.make_batched_step(spec, bspec, lane_major=True)
    assert s4 is not s1
    # the memo is bounded: counts and weight bytes both enforce eviction
    with batch_mod._STEP_CACHE_LOCK:
        assert len(batch_mod._STEP_CACHE) <= \
            batch_mod._STEP_CACHE_MAX_ENTRIES
    batch_mod.clear_step_cache()


def test_step_cache_engines_share_step_and_stay_independent():
    """Two engines over the same config share the cached step but keep
    independent histories/output (the step is stateless by contract)."""
    import speex_resampler_tpu.parallel.batch as batch_mod

    batch_mod.clear_step_cache()
    S, C = 3, 2
    fa = _random_frames(S, 5000, C, seed=17)
    fb = _random_frames(S, 5000, C, seed=18)
    ea = BatchedResampler(S, C, 24000, 48000, 5)
    eb = BatchedResampler(S, C, 24000, 48000, 5)
    assert ea._step is eb._step
    ya = np.concatenate([ea.process(fa), ea.flush()], axis=1)
    yb = np.concatenate([eb.process(fb), eb.flush()], axis=1)
    # independent single-engine runs on fresh engines agree exactly
    batch_mod.clear_step_cache()
    ea2 = BatchedResampler(S, C, 24000, 48000, 5)
    ya2 = np.concatenate([ea2.process(fa), ea2.flush()], axis=1)
    eb2 = BatchedResampler(S, C, 24000, 48000, 5)
    yb2 = np.concatenate([eb2.process(fb), eb2.flush()], axis=1)
    assert np.array_equal(ya, ya2)
    assert np.array_equal(yb, yb2)
