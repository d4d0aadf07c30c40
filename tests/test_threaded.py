"""Concurrency of the SHARED host-side caches.

design_filter is lru_cache'd, so FilterSpec instances — and their
lazily-built phase tables — are shared across engines.  The reference's
share-nothing contract is "a new resampler for every audio stream"
(Readme.md:20-21); serving that from a
threaded host (MultiFleet buckets built on demand from request threads)
makes concurrent engine CONSTRUCTION for the same config the load-bearing
case.  These tests race exactly that; the contract is
ops/filter_design.SPEC_BUILD_LOCK (see its comment).

Correctness oracle: every thread's engine must produce output identical to
a single-threaded engine of the same config (a torn table or half-built
cache shows up as wrong samples or an exception).
"""

import concurrent.futures as cf
import threading

import numpy as np
import pytest

from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.runtime.multifleet import MultiFleet


def _fresh_specs():
    """Clear the design cache so every run races COLD builds."""
    fd.design_filter.cache_clear()


CONFIGS = [(44100, 48000, 7), (24000, 48000, 5), (44100, 24000, 5),
           (48000, 44100, 10)]


@pytest.mark.parametrize("rep", range(3))
def test_concurrent_engine_construction_same_config(rep):
    """N threads build + run engines for the SAME config concurrently;
    outputs must match the single-threaded engine bit-for-bit."""
    _fresh_specs()
    S, C = 2, 2
    rng = np.random.default_rng(100 + rep)
    x = (rng.integers(-32768, 32768, size=(S, 1024, C)) // 2).astype(
        np.int16)

    def build_and_run(i):
        ir, orr, q = CONFIGS[i % len(CONFIGS)]
        eng = BatchedResampler(S, C, ir, orr, q, target_chunk_frames=256)
        y = eng.process(x)
        return (ir, orr, q), y

    n_threads = 8
    with cf.ThreadPoolExecutor(n_threads) as ex:
        results = list(ex.map(build_and_run, range(n_threads * 2)))

    # single-threaded goldens (fresh cache again so they build clean)
    _fresh_specs()
    golden = {}
    for key, y in results:
        if key not in golden:
            eng = BatchedResampler(S, C, *key, target_chunk_frames=256)
            golden[key] = eng.process(x)
        np.testing.assert_array_equal(y, golden[key])


@pytest.mark.parametrize("rep", range(2))
def test_concurrent_lazy_table_builds(rep):
    """Race the spec's lazy table builds: threads request the float phase
    table and the fixed interpolation tensors of the SAME cold specs at
    once; every thread must see the tables a single-threaded build
    makes (a torn double-checked build shows up as a mismatch)."""
    _fresh_specs()

    def grab(i):
        fixed = bool(i % 2)
        spec = fd.design_filter(147, 160, 7, fixed_point=fixed)
        t = spec.interp_taps if fixed else spec.phase_table
        return fixed, np.asarray(t).copy()

    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(grab, range(24)))

    _fresh_specs()
    want = {False: fd.design_filter(147, 160, 7).phase_table,
            True: fd.design_filter(147, 160, 7, fixed_point=True
                                   ).interp_taps}
    for fixed, t in got:
        np.testing.assert_array_equal(t, want[fixed])


def test_multifleet_threaded_serving():
    """MultiFleet driven from N threads: each thread owns disjoint streams
    across heterogeneous buckets (buckets are constructed on demand — the
    cross-thread shared state is the spec caches and the stager pools), a
    lock striping the engine itself per bucket.  Engine-level calls are
    serialized per bucket by the caller (the documented contract: engines
    are externally synchronized; the SHARED caches are what must be safe),
    so each thread here uses its own MultiFleet but all race the same
    process-wide spec caches."""
    _fresh_specs()
    C = 2
    rng = np.random.default_rng(7)
    frames = (rng.integers(-32768, 32768, size=(512, C)) // 2).astype(
        np.int16)

    def serve(i):
        mf = MultiFleet(channels=C, capacity_per_bucket=4,
                        target_chunk_frames=256)
        outs = {}
        for j, (ir, orr, q) in enumerate(CONFIGS):
            sid = f"s{i}-{j}"
            mf.add_stream(sid, ir, orr, q)
            mf.push(sid, frames)
        mf.poll()
        for j in range(len(CONFIGS)):
            mf.end_stream(f"s{i}-{j}")
        mf.poll()
        for j in range(len(CONFIGS)):
            outs[CONFIGS[j]] = mf.pull(f"s{i}-{j}")
        return outs

    with cf.ThreadPoolExecutor(6) as ex:
        all_outs = list(ex.map(serve, range(6)))

    golden = serve(999)
    for outs in all_outs:
        for key, y in outs.items():
            np.testing.assert_array_equal(y, golden[key])


def test_native_set_threads_concurrent_with_fill():
    """srt_set_threads swaps the pool while other threads gather/scatter;
    the C++ shared_mutex guard must keep every slab correct."""
    from speex_resampler_tpu.runtime.native import load_runtime, NativeStager
    if load_runtime() is None:
        pytest.skip("native runtime unavailable")
    S, C, n_in = 16, 2, 256
    st = NativeStager(S, C, n_in)
    rng = np.random.default_rng(3)
    frames = rng.integers(-32768, 32768, size=(S, n_in, C)).astype(np.int16)
    golden = np.empty((n_in, S * C), dtype=np.int16)
    for s in range(S):
        st.push(s, frames[s])
    st.fill_launch(out=golden)

    stop = threading.Event()
    errors = []

    def churn_threads():
        k = 1
        while not stop.is_set():
            try:
                st.set_threads(1 + (k % 8))
            except Exception as e:  # pragma: no cover - failure capture
                errors.append(e)
                return
            k += 1

    t = threading.Thread(target=churn_threads)
    t.start()
    try:
        slab = np.empty((n_in, S * C), dtype=np.int16)
        for _ in range(50):
            for s in range(S):
                st.push(s, frames[s])
            st.fill_launch(out=slab)
            np.testing.assert_array_equal(slab, golden)
            y = st.unpack_all(golden)
            np.testing.assert_array_equal(
                y, golden.reshape(n_in, S, C).transpose(1, 0, 2))
    finally:
        stop.set()
        t.join()
    assert not errors
