"""24/7-serving soak: minutes of MultiFleet churn with flat-RSS assertion.

The round-4 review: MultiFleet LRU-evicts idle buckets and the watermarks
bound memory *per unit test*, but nothing ran attach/detach/rate-switch
churn for minutes asserting RSS stays flat — the 24/7 serving claim in
docs/serving.md rested on unit tests alone.  This experiment is that
evidence (reference role: the unbounded Transform-stream use,
/root/reference/src/index.ts:121-162, run forever).

Churn mix per round (every hazard the serving surface exposes):
  * push/poll/pull on every live stream (steady serving)
  * one detach + one attach with a NEVER-REUSED stream id (leaks in the
    sid->stream map or carryover GC show up as monotonic growth)
  * every 3rd round an exact mid-stream rate switch (magic-sample
    migration + destination-bucket reservation/pinning)
  * every 10th round a graceful end_stream + drain (flush path)
  * every 25th round a full state_dict() checkpoint + stats() snapshot
    (serialization allocations) and an extra poll()
Pushes honor backpressure exactly like a production client: ``writable``
is consulted first and refusals are counted (lockstep buckets with a
freshly attached slot legitimately refuse while the new lane fills its
first quantum — the refusal path is part of what soaks).
Bucket count cycles above max_idle_buckets so the idle-LRU eviction path
(and transparent rebuild) runs continuously.

RSS methodology: VmRSS sampled from /proc/self/status each round.  The
baseline is taken AFTER a warmup fraction (JIT compiles, bucket engine
builds, and numpy pools all land there); the assertion is on growth past
that baseline — peak and final — plus a least-squares slope in MB/min
over the post-baseline samples, which a real per-round leak cannot hide.

Writes build/soak_multifleet.json:
  {duration_s, rounds, launches, out_samples, rss_baseline_mb, rss_peak_mb,
   rss_final_mb, growth_peak_mb, growth_final_mb, slope_mb_per_min,
   degraded, pass}

Run: SOAK_S=300 python experiments/soak_multifleet.py
(the soak exercises HOST memory hygiene on whatever backend JAX picks;
``JAX_PLATFORMS=cpu`` keeps it off the accelerator).
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from speex_resampler_tpu.runtime.multifleet import MultiFleet

SOAK_S = float(os.environ.get("SOAK_S", "240"))
WARMUP_FRAC = 0.25
GROWTH_PEAK_MB = 64.0    # absolute ceiling past baseline, any sample
GROWTH_FINAL_MB = 32.0   # where RSS must settle at the end
SLOPE_MB_PER_MIN = 4.0   # post-baseline least-squares drift ceiling

CONFIGS = [(44100, 48000, 7), (24000, 48000, 5),
           (48000, 44100, 10), (44100, 24000, 5),
           (32000, 48000, 3), (16000, 8000, 4)]
CHANNELS = 2
PER_BUCKET = 12
CHUNK_FRAMES = 512


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS")


def main() -> int:
    rng = np.random.default_rng(7)
    # staged watermark must clear the LARGEST bucket's launch quantum
    # (48000->44100 q10 resolves to 20480 frames at this target on the
    # CPU dense geometry; a watermark below the quantum is a config
    # error FleetResampler rejects up front)
    mf = MultiFleet(channels=CHANNELS, capacity_per_bucket=PER_BUCKET + 1,
                    target_chunk_frames=CHUNK_FRAMES,
                    max_staged_frames=24576,
                    max_banked_frames=65536,
                    max_idle_buckets=3)   # < len(CONFIGS): eviction churns
    # push one full launch quantum per stream per round (the round-4 soak
    # pushed fixed 512-frame chunks; the largest bucket's quantum is
    # 20480 frames at this target on the CPU dense geometry, so 3 rounds
    # never reached readiness and the artifact recorded launches=0 —
    # churn without a single resample).  Quanta are config-deterministic;
    # fill the map lazily after each config's first bucket exists.
    chunks: dict[tuple, np.ndarray] = {}

    def chunk_for(cfg):
        if cfg not in chunks:
            q = mf._buckets[cfg].fleet.bspec.in_per_launch
            chunks[cfg] = (rng.integers(-32768, 32768,
                                        size=(q, CHANNELS))
                           // 2).astype(np.int16)
        return chunks[cfg]

    live: list[tuple[str, tuple]] = []
    next_sid = 0

    def attach(cfg):
        nonlocal next_sid
        sid = f"s{next_sid}"      # never reused: exercises sid-map GC
        next_sid += 1
        mf.add_stream(sid, *cfg)
        live.append((sid, cfg))

    # initial population over the first 4 configs only; the rest enter
    # via churn so bucket build/evict/rebuild cycles the whole run
    for b, cfg in enumerate(CONFIGS[:4]):
        for _ in range(PER_BUCKET // 2):
            attach(cfg)

    t0 = time.monotonic()
    samples: list[tuple[float, float]] = []   # (t, rss_mb)
    rounds = launches = out_samples = refused = 0
    baseline = None
    peak_after = 0.0
    while time.monotonic() - t0 < SOAK_S:
        rounds += 1
        for sid, cfg in live:
            c = chunk_for(cfg)
            if mf.writable(sid, len(c)):
                mf.push(sid, c)
            else:
                refused += 1
        launches += mf.poll()
        for sid, _ in live:
            out_samples += mf.pull(sid).size
        # churn: one detach (abrupt), one attach of a rotating config
        drop = rounds % len(live)
        sid, _ = live.pop(drop)
        mf.remove_stream(sid)
        attach(CONFIGS[rounds % len(CONFIGS)])
        if rounds % 3 == 0:
            sid, cfg = live[rounds % len(live)]
            new = CONFIGS[(CONFIGS.index(cfg) + 1) % len(CONFIGS)]
            mf.set_stream_rate(sid, new[0], new[1], new[2])
            live[rounds % len(live)] = (sid, new)
        if rounds % 10 == 0:
            sid, cfg = live.pop(0)
            mf.end_stream(sid)
            mf.pull(sid)          # drain the tail -> full GC
            attach(cfg)
        if rounds % 25 == 0:
            state = mf.state_dict()
            del state
            mf.stats()
            mf.poll()   # NOT flush(): flush is the end-of-world drain
        now = time.monotonic() - t0
        r = rss_mb()
        samples.append((now, r))
        if baseline is None and now >= WARMUP_FRAC * SOAK_S:
            baseline = r
        if baseline is not None:
            peak_after = max(peak_after, r - baseline)
        if rounds % 50 == 0:
            print(f"[{now:6.0f}s] round {rounds} rss {r:.1f} MB "
                  f"live {len(live)} buckets {len(mf._buckets)}",
                  flush=True)

    final = rss_mb()
    if baseline is None:          # ultra-short run: everything is warmup
        baseline = samples[0][1]
    post = [(t, r) for t, r in samples if r is not None
            and t >= WARMUP_FRAC * SOAK_S]
    slope = 0.0
    if len(post) >= 2:
        ts = np.array([p[0] for p in post])
        rs = np.array([p[1] for p in post])
        slope = float(np.polyfit(ts, rs, 1)[0]) * 60.0   # MB/min
    ok = (peak_after < GROWTH_PEAK_MB
          and final - baseline < GROWTH_FINAL_MB
          and slope < SLOPE_MB_PER_MIN
          and not mf.degraded
          # a soak that never launched churned buckets but resampled
          # nothing — flat RSS would be vacuous evidence
          and launches > 0 and out_samples > 0)
    result = {
        "duration_s": round(time.monotonic() - t0, 1),
        "rounds": rounds, "launches": launches,
        "out_samples": out_samples, "pushes_refused": refused,
        "streams_created": next_sid,
        "configs": len(CONFIGS), "max_idle_buckets": 3,
        "rss_baseline_mb": round(baseline, 1),
        "rss_peak_mb": round(baseline + peak_after, 1),
        "rss_final_mb": round(final, 1),
        "growth_peak_mb": round(peak_after, 1),
        "growth_final_mb": round(final - baseline, 1),
        "slope_mb_per_min": round(slope, 3),
        "thresholds": {"growth_peak_mb": GROWTH_PEAK_MB,
                       "growth_final_mb": GROWTH_FINAL_MB,
                       "slope_mb_per_min": SLOPE_MB_PER_MIN},
        "degraded": mf.degraded,
        "backend": jax.default_backend(),
        "pass": bool(ok),
    }
    out = os.path.join(os.path.dirname(__file__), os.pardir, "build",
                       "soak_multifleet.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
