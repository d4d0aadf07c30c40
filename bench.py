"""Throughput benchmark of the batched resampler on one GPU.

Measures the flagship deployment — 1024 concurrent stereo streams,
44.1 kHz -> 48 kHz at quality 7, 9408-frame launches — plus the other
geometry families, the fixed-point universe, the hard-latency voip
quantum, the serving front-ends and the host stager.  Correctness is the
job of the tests and ``chip_smoke.py``; this script only times.

Device step times come from ITERS chained launches inside one lax.scan
dispatch, timed at two scan lengths: the slope removes the per-dispatch
overhead.  The scan input is salted per iteration so XLA cannot hoist
the GEMM out of the loop.  Front-end numbers are wall-clock around the
public APIs.

Run on the GPU (``python bench.py``); it exits 2 when JAX finds none.
Prints one JSON line whose ``device`` names the platform, device kind and
count, and ``card`` the card's name and power limit.
"""

import functools
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_STREAMS = 1024
CHANNELS = 2
FLAGSHIP = (44100, 48000, 7)
TARGET_IN_FRAMES = 9408
ITERS_SHORT, ITERS_LONG = 4, 24
REPS = 4
SWEEP = [
    # (in_rate, out_rate, quality)   geometry exercised
    (24000, 48000, 5),   # direct path, group factor > 1
    (48000, 44100, 10),  # 147-phase weight cycle, double-accumulator q10
    (44100, 24000, 5),   # downsample (longer filter, scaled cutoff)
]


def _note(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def measure_config(in_rate, out_rate, quality, *,
                   target_in_frames=TARGET_IN_FRAMES, fixed_point=False,
                   n_slopes=3, max_latency_ms=None):
    """Median scan-slope seconds per launch + geometry for one config."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from speex_resampler_tpu.ops import filter_design as fd
    from speex_resampler_tpu.parallel.batch import (_launch_geometry,
                                                    make_batched_step)
    B = N_STREAMS * CHANNELS
    g = math.gcd(in_rate, out_rate)
    spec = fd.design_filter(in_rate // g, out_rate // g, quality,
                            fixed_point=fixed_point)
    max_in = (None if max_latency_ms is None
              else int(max_latency_ms * in_rate / 1000))
    bspec = _launch_geometry(spec, target_in_frames, max_in_frames=max_in)
    bstep = make_batched_step(spec, bspec)
    step, w = bstep.fn, bstep.w
    n_real = bspec.in_per_launch

    rng = np.random.default_rng(0)
    x_np = np.zeros((bstep.chunk_rows, B), dtype=np.int16)
    x_np[:n_real] = (rng.integers(-32768, 32768, size=(n_real, B))
                     // 2).astype(np.int16)
    x = jnp.asarray(x_np)
    hist0 = jnp.zeros((bstep.hist_rows, B), dtype=jnp.int16)

    @functools.partial(jax.jit, static_argnames=("iters",))
    def rep(hist, x, w, salt, iters):
        # Each step must depend on the iteration or XLA's loop-invariant
        # code motion hoists it: only the first blocks read hist, so the
        # x-only GEMM would leave the scan.  x is salted too, and carried
        # so the row update aliases in place instead of recopying it.
        def body(carry, _):
            h, xc, chk = carry
            s = (chk + salt).astype(jnp.int16)
            xs = xc.at[0, :].add(s)
            h2, y = step(h.at[0, :].add(s), xs, w)
            return (h2, xs, chk + y[0, 0].astype(jnp.int32)), None
        (h, xc, chk), _ = lax.scan(body, (hist, x, jnp.int32(0)),
                                   length=iters)
        return chk

    for it in (ITERS_SHORT, ITERS_LONG):
        jax.device_get(rep(hist0, x, w, jnp.int16(99), it))  # compile+warm

    def one_slope(seed):
        ts = {}
        for it in (ITERS_SHORT, ITERS_LONG):
            best = float("inf")
            for i in range(REPS):
                t0 = time.perf_counter()
                jax.device_get(rep(hist0, x, w, jnp.int16(seed + i), it))
                best = min(best, time.perf_counter() - t0)
            ts[it] = best
        return (ts[ITERS_LONG] - ts[ITERS_SHORT]) / (ITERS_LONG
                                                     - ITERS_SHORT)

    slopes = sorted(one_slope(k) for k in range(n_slopes))
    per_launch = slopes[len(slopes) // 2]
    return {
        "kernel": bspec.kernel,
        "launch_ms": per_launch * 1e3,
        "launch_ms_runs": [v * 1e3 for v in slopes],
        "out_samples_per_sec": bspec.out_per_launch * B / per_launch,
        "in_samples_per_sec": bspec.in_per_launch * B / per_launch,
        "in_frames_per_launch": bspec.in_per_launch,
        "out_frames_per_launch": bspec.out_per_launch,
        "x_np": x_np,
    }


def stager_bench():
    """Native host stager throughput: gather (per-stream FIFOs -> launch
    slab) and scatter (result slab -> per-stream PCM) int16 samples/s at
    the flagship geometry, for both slab layouts — lane-major (``*_lm``,
    the FleetResampler path: contiguous per-stream rows, transpose rides
    the device) and time-major."""
    from speex_resampler_tpu.runtime.native import NativeStager
    S, C, n_in, n_out = N_STREAMS, CHANNELS, TARGET_IN_FRAMES, 10240
    K = 8
    st = NativeStager(S, C, n_in)
    threads = st.set_threads(4)
    rng = np.random.default_rng(0)
    frames = rng.integers(-32768, 32768,
                          size=(S, K * n_in, C)).astype(np.int16)
    slab = np.empty((n_in, S * C), dtype=np.int16)
    slab_lm = np.zeros((S * C, n_in), dtype=np.int16)
    y = rng.integers(-32768, 32768, size=(n_out, S * C)).astype(np.int16)
    y_lm = np.ascontiguousarray(y.T)
    dst = np.empty((S, n_out, C), dtype=np.int16)
    g_best = s_best = gl_best = sl_best = 9e9
    for _ in range(3):
        for s in range(S):
            st.push(s, frames[s])
        t0 = time.perf_counter()
        for _ in range(K // 2):
            st.fill_launch(out=slab)
        g_best = min(g_best, (time.perf_counter() - t0) / (K // 2))
        t0 = time.perf_counter()
        for _ in range(K - K // 2):
            st.fill_launch_lm(slab_lm)
        gl_best = min(gl_best, (time.perf_counter() - t0) / (K - K // 2))
        t0 = time.perf_counter()
        for _ in range(K):
            st.unpack_all(y)
        s_best = min(s_best, (time.perf_counter() - t0) / K)
        t0 = time.perf_counter()
        for _ in range(K):
            st.unpack_all_lm(y_lm, out=dst)
        sl_best = min(sl_best, (time.perf_counter() - t0) / K)
    return {"threads": threads,
            "gather_samples_per_sec": n_in * S * C / g_best,
            "scatter_samples_per_sec": y.size / s_best,
            "gather_lm_samples_per_sec": n_in * S * C / gl_best,
            "scatter_lm_samples_per_sec": y.size / sl_best}


def single_stream_bench(seconds=0.8):
    """The reference's primary use case: one resampler per stream,
    interactive 1024-frame chunks through SpeexResampler.process_chunk on
    the default route (native host loops for <= 8 channels)."""
    from speex_resampler_tpu.api import SpeexResampler

    def _one(channels, fixed):
        r = SpeexResampler(channels, 44100, 48000, 5, fixed_point=fixed)
        rng = np.random.default_rng(0)
        chunk = rng.integers(-32768, 32768, (1024 * channels,)) \
            .astype(np.int16).tobytes()
        for _ in range(8):
            r.process_chunk(chunk)
        best = 0.0
        for _ in range(3):
            n_out = 0
            t0 = time.perf_counter()
            while (dt := time.perf_counter() - t0) < seconds / 3:
                n_out += len(r.process_chunk(chunk)) // 2
            best = max(best, n_out / dt)
        return best

    return {"chunk_frames": 1024, "config": "44100->48000 q5",
            "out_samples_per_sec": _one(1, False),
            "stereo_out_samples_per_sec": _one(2, False),
            "fixed_out_samples_per_sec": _one(1, True),
            "vs_reference_cpu": "not measured"}


def fleet_e2e(fixed_point=False, n_streams=256):
    """End to end through FleetResampler (ragged staging, native gather
    and scatter, device launches, readback) in out samples/s, with the
    per-phase breakdown (gather / dispatch / readback / unpack ms per
    launch), and the same poll loop with a device-resident consumer fused
    into the step (readback of one checksum instead of the audio)."""
    import jax.numpy as jnp
    from speex_resampler_tpu.runtime.fleet import FleetResampler
    S, C = n_streams, CHANNELS
    fleet = FleetResampler(S, C, *FLAGSHIP,
                           target_chunk_frames=TARGET_IN_FRAMES,
                           fixed_point=fixed_point)
    q = fleet.bspec.in_per_launch
    rng = np.random.default_rng(0)
    frames = (rng.integers(-32768, 32768, size=(S, q, C)) // 2).astype(
        np.int16)
    for s in range(S):
        fleet.push(s, frames[s])
    fleet.poll()  # warm
    for s in range(S):
        fleet.pull(s)
    fleet.stats = type(fleet.stats)()
    produced = 0
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        for s in range(S):
            fleet.push(s, frames[s])
        fleet.poll()
        for s in range(S):
            produced += fleet.pull(s).size
    dt = time.perf_counter() - t0
    st = fleet.stats
    mins = st.phase_ms_min()
    host_ms_min = mins.get("gather", 0.0) + mins.get("unpack", 0.0)
    per_launch_out = produced / st.launches if st.launches else 0
    out = {"out_samples_per_sec": produced / dt,
           "streams": S, "launches": st.launches,
           "degraded": fleet.degraded,
           "pipeline_depth": fleet._depth,
           "phase_ms_per_launch": st.phase_ms_per_launch(),
           "phase_ms_min": mins,
           "accounted_frac": (sum(st.phase_seconds.values()) / dt
                              if dt else None),
           "host_path_samples_per_sec": (
               per_launch_out / (host_ms_min * 1e-3)
               if host_ms_min else None)}
    if not fixed_point:
        fl2 = FleetResampler(
            S, C, *FLAGSHIP, target_chunk_frames=TARGET_IN_FRAMES,
            device_consumer=lambda y: jnp.sum(y.astype(jnp.int32)))
        for s in range(S):
            fl2.push(s, frames[s])
        fl2.poll()  # warm the fused step
        best = None
        for _ in range(6):
            for s in range(S):
                fl2.push(s, frames[s])
            t0 = time.perf_counter()
            n = fl2.poll()
            dtp = time.perf_counter() - t0
            if n and (best is None or dtp / n < best):
                best = dtp / n
        out["device_consumer_out_samples_per_sec"] = (
            fl2.bspec.out_per_launch * S * C / best)
        out["device_consumer_ms_per_launch"] = best * 1e3
    return out


def multifleet_e2e(n_streams=1024, target_frames=2048):
    """MultiFleet with ``n_streams`` streams over 4 config buckets, a
    detach, an attach and an exact rate switch mixed in; aggregate out
    samples/s over 10 timed rounds with push/poll/pull attributed."""
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    configs = [FLAGSHIP, (24000, 48000, 5), (48000, 44100, 10),
               (44100, 24000, 5)]
    per = n_streams // len(configs)
    # +1 headroom: the rate switch reserves a slot in its destination
    # bucket before the source lane is torn down
    mf = MultiFleet(channels=CHANNELS, capacity_per_bucket=per + 1,
                    target_chunk_frames=target_frames)
    rng = np.random.default_rng(1)
    sids = []
    for b, cfg in enumerate(configs):
        for i in range(per):
            sid = f"b{b}s{i}"
            mf.add_stream(sid, *cfg)
            sids.append((sid, cfg))
    chunks = {cfg: (rng.integers(
        -32768, 32768,
        size=(mf._buckets[cfg].fleet.bspec.in_per_launch, CHANNELS))
        // 2).astype(np.int16) for cfg in configs}

    def round_trip():
        for sid, cfg in sids:
            mf.push(sid, chunks[cfg])
        mf.poll()
        return sum(mf.pull(sid).size for sid, _ in sids)

    round_trip()   # warm every bucket
    mf.end_stream(sids[0][0])
    mf.pull(sids[0][0])
    mf.add_stream("fresh", *configs[0])
    sids[0] = ("fresh", configs[0])
    mf.set_stream_rate(sids[1][0], *configs[1])
    sids[1] = (sids[1][0], configs[1])
    for _ in range(2):
        round_trip()   # the post-switch geometry is warm too
    mf.reset_stats()
    produced, iters = 0, 10
    push_s = pull_s = poll_s = 0.0
    iter_ms = []
    t0 = time.perf_counter()
    for _ in range(iters):
        ti = time.perf_counter()
        for sid, cfg in sids:
            mf.push(sid, chunks[cfg])
        tp = time.perf_counter()
        mf.poll()
        tq = time.perf_counter()
        for sid, _ in sids:
            produced += mf.pull(sid).size
        te = time.perf_counter()
        push_s += tp - ti
        poll_s += tq - tp
        pull_s += te - tq
        iter_ms.append((te - ti) * 1e3)
    dt = time.perf_counter() - t0
    phase_s = sum(sum(b.fleet.stats.phase_seconds.values())
                  for b in mf._buckets.values())
    srt = sorted(iter_ms)
    return {"out_samples_per_sec": produced / dt,
            "streams": n_streams, "buckets": len(configs),
            "degraded": mf.degraded, "timed_rounds": iters,
            "iter_ms_median": srt[len(srt) // 2], "iter_ms_min": srt[0],
            "phase_push_ms": push_s / iters * 1e3,
            "phase_poll_ms": poll_s / iters * 1e3,
            "phase_pull_ms": pull_s / iters * 1e3,
            "phase_fleet_internal_ms": phase_s / iters * 1e3,
            "accounted_frac": (push_s + pull_s + phase_s) / dt}


def _row(m, *extra):
    keys = ("kernel", "launch_ms", "launch_ms_runs", "out_samples_per_sec",
            "in_samples_per_sec", "in_frames_per_launch",
            "out_frames_per_launch") + extra
    return {k: m[k] for k in keys if k in m}


def main() -> int:
    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"bench: needs a gpu device; JAX found platform "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 2
    from speex_resampler_tpu.utils.gpu_script import (card_info,
                                                      use_compile_cache)
    use_compile_cache(REPO)
    from speex_resampler_tpu.parallel.batch import BatchedResampler

    _note("flagship")
    flag = measure_config(*FLAGSHIP, n_slopes=5)
    extra = {"flagship": _row(flag), "fixed_point_universe": {},
             "sweep": {}}
    for (ir, orate, q) in [FLAGSHIP, (24000, 48000, 5)]:
        _note(f"fixed {ir}->{orate} q{q}")
        extra["fixed_point_universe"][f"{ir}->{orate} q{q}"] = _row(
            measure_config(ir, orate, q, fixed_point=True))
    for (ir, orate, q) in SWEEP:
        _note(f"sweep {ir}->{orate} q{q}")
        extra["sweep"][f"{ir}->{orate} q{q}"] = _row(
            measure_config(ir, orate, q))
    _note("hard latency (voip 20 ms)")
    m = measure_config(44100, 48000, 3, max_latency_ms=20.0)
    extra["hard_latency"] = _row(m) | {
        "quantum_ms": m["in_frames_per_launch"] / 44100 * 1e3}
    _note("single stream")
    extra["single_stream"] = single_stream_bench()
    _note("stager")
    extra["stager"] = stager_bench()
    _note("fleet e2e")
    extra["fleet_e2e"] = fleet_e2e()
    _note("fleet e2e fixed")
    extra["fleet_e2e_fixed"] = fleet_e2e(fixed_point=True)
    _note("multifleet 1024x4")
    extra["multifleet"] = multifleet_e2e()

    _note("e2e BatchedResampler")
    eng = BatchedResampler(N_STREAMS, CHANNELS, *FLAGSHIP,
                           target_chunk_frames=flag["in_frames_per_launch"])
    chunk_np = flag["x_np"][:flag["in_frames_per_launch"]]
    eng.process(chunk_np)  # warm
    t0 = time.perf_counter()
    produced = sum(eng.process(chunk_np).size for _ in range(5))
    extra["e2e_out_samples_per_sec"] = produced / (time.perf_counter() - t0)
    extra["e2e_degraded"] = eng.degraded

    print(json.dumps({
        "metric": "output samples/sec, batched q7 44.1k->48k stereo "
                  f"({N_STREAMS} streams, device step)",
        "value": flag["out_samples_per_sec"],
        "unit": "samples/sec",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
        "card": card_info(),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
