#!/usr/bin/env python3
"""On-device smoke run of the batched resampler's main path.

Runs the serving stack at its flagship deployment — 1024 concurrent stereo
streams (2048 lanes), 44.1 kHz -> 48 kHz at quality 7, 9408-frame launches —
in both numeric universes, then the other geometry families, the fleet
front-ends and the single-stream device route.  Every output is compared
with the repo's plain references:

  float  ops/fir_exact.resample_exact_state (order-faithful, bit-identical
         to the reference C): max |err| <= 1 LSB, ties <= lsb_tie_limit(n)
  fixed  ops/fir_fixed.resample_fixed: zero mismatches

Usage:
  python chip_smoke.py                # one GPU, every phase
  python chip_smoke.py --four-cards   # the lane-sharded path on 4 GPUs only

Each phase prints one JSON line.  The last stdout line is one JSON object
{"ok": true, "device": {...}}; a failed comparison, a degraded engine or an
exception exits non-zero without it.  Exits 2 when JAX's first device is
not a GPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
EXPECTED_PLATFORM = "gpu"
FLAGSHIP = (44100, 48000, 7)
QUANTUM = 9408          # the flagship's launch quantum, input frames/lane
CHANNELS = 2


@dataclasses.dataclass(frozen=True)
class Size:
    streams: int = 1024            # flagship stereo streams (2048 lanes)
    family_streams: int = 64       # stereo streams per other-family engine
    multifleet_streams: int = 256  # stereo streams per MultiFleet bucket
    launches: int = 3              # full launches before the flush
    single_chunks: int = 50        # 20 ms chunks through the single stream


SIZE = Size()


# -- references and verdicts ---------------------------------------------


def _pcm(rng, S: int, n: int, C: int = CHANNELS) -> np.ndarray:
    # half scale keeps outputs clear of the saturation clamp
    return (rng.integers(-32768, 32768, size=(S, n, C)) // 2).astype(
        np.int16)


def _lanes(frames: np.ndarray) -> np.ndarray:
    """[S, n, C] -> lane-major [S*C, n] (lane = stream*C + channel)."""
    S, n, C = frames.shape
    return np.ascontiguousarray(frames.transpose(0, 2, 1).reshape(S * C, n))


def reference(lanes: np.ndarray, spec, n_out: int) -> np.ndarray:
    """Fresh-stream outputs of int16 lanes [B, n] from the plain host
    references (zero history, phase 0), split over threads by lane block:
    the order-faithful float loops or the exact fixed loops."""
    from speex_resampler_tpu.ops import fir_exact, fir_fixed
    from speex_resampler_tpu.runtime import native
    native.load_runtime()   # build/load once, before the worker threads
    N = spec.filt_len

    def one(block):
        X = np.concatenate(
            [np.zeros((block.shape[0], N - 1), np.int16), block], axis=1)
        if spec.fixed_point:
            return fir_fixed.resample_fixed(X, 0, 0, n_out, spec)
        return fir_exact.resample_exact_state(X.astype(np.float32), 0, 0,
                                              n_out, spec)

    blocks = np.array_split(lanes, max(1, min(len(lanes),
                                              os.cpu_count() or 1)))
    with concurrent.futures.ThreadPoolExecutor() as ex:
        return np.concatenate(list(ex.map(one, blocks)), axis=0)


def verdict(phase: str, got: np.ndarray, want: np.ndarray, *, exact: bool,
            **info) -> dict:
    """Compare int16 outputs: zero mismatches when ``exact``, else max
    |err| <= 1 LSB with ties within lsb_tie_limit(n).  A degraded engine
    fails whatever the numbers."""
    from speex_resampler_tpu.utils.parity import lsb_diff, lsb_tie_limit
    rec = {"phase": phase, **info}
    if got.shape != want.shape:
        rec.update(ok=False,
                   error=f"shape {got.shape} != reference {want.shape}")
        return rec
    max_err, ties, n = lsb_diff(got, want)
    rec.update(n=n, max_err=max_err, ties=ties)
    if exact:
        rec.update(bound="0 mismatches", ok=ties == 0)
    else:
        limit = lsb_tie_limit(n)
        rec.update(bound=f"max|err|<=1, ties<={limit:.1f}",
                   ok=max_err <= 1 and ties <= limit)
    if info.get("degraded", False):
        rec["ok"] = False
    return rec


# -- step inspection -----------------------------------------------------


def float_dot_precisions(lowered_text: str) -> list[str]:
    """Operand precision of every f32 dot_general in StableHLO text."""
    found = []
    for line in lowered_text.splitlines():
        if "stablehlo.dot_general" not in line or "xf32>" not in line:
            continue
        m = re.search(r"precision = \[(\w+), (\w+)\]", line)
        found.append(m.group(1) if m and m.group(1) == m.group(2)
                     else (m.group(0) if m else "DEFAULT"))
    return found


def int8_dots(lowered_text: str) -> int:
    """Count of dot_generals with int8 operands and int32 results."""
    return sum(1 for line in lowered_text.splitlines()
               if "stablehlo.dot_general" in line and "xi8>" in line
               and "xi32>" in line.rsplit("->", 1)[-1])


def inspect_step(fn, *args, **static) -> dict:
    """Lower and compile one step; report its dot precisions, int8 dots,
    TF32 mentions in the compiled module, and XLA's memory analysis."""
    lowered = fn.lower(*args, **static)
    text = lowered.as_text()
    compiled = lowered.compile()
    ctext = compiled.as_text() or ""
    mem = compiled.memory_analysis()
    return {
        "f32_dot_precisions": float_dot_precisions(text),
        "int8_dots": int8_dots(text),
        "compiled_tf32_mentions": len(re.findall("tf32", ctext, re.I)),
        "compiled_gemm_calls": len(re.findall(r"gemm", ctext)),
        "memory_analysis": None if mem is None else {
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")},
    }


def _mem(device, key: str = "peak_bytes_in_use"):
    """One of the device's memory_stats (None where it keeps none)."""
    stats = device.memory_stats()
    return None if not stats else stats.get(key)


# -- phases --------------------------------------------------------------


def run_batched(phase: str, S: int, in_rate: int, out_rate: int,
                quality: int, *, fixed: bool, launches: int, seed: int,
                target: int = QUANTUM, max_latency_ms: float | None = None,
                mesh=None, inspect: bool = False,
                keep_engine: bool = False):
    """One BatchedResampler through ``launches`` full launches plus a
    flush, fed in ragged pieces; every lane compared with the reference.
    Returns (record, output lanes[, engine])."""
    from speex_resampler_tpu.ops import phase as ph
    from speex_resampler_tpu.parallel.batch import BatchedResampler
    t0 = time.perf_counter()
    eng = BatchedResampler(S, CHANNELS, in_rate, out_rate, quality,
                           target_chunk_frames=target, fixed_point=fixed,
                           max_latency_ms=max_latency_ms, mesh=mesh)
    compile_s = time.perf_counter() - t0
    q = eng.in_frames_per_launch
    n = launches * q + q // 3 + 1
    frames = _pcm(np.random.default_rng(seed), S, n)
    cuts = [0, q // 2 + 7, 2 * q + 13, n]
    t0 = time.perf_counter()
    outs = [eng.process(frames[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    ran = sum(o.shape[1] for o in outs) // eng.out_frames_per_launch
    outs.append(eng.flush())
    run_s = time.perf_counter() - t0
    got = _lanes(np.concatenate(outs, axis=1))
    spec = eng.spec
    want = reference(_lanes(frames), spec,
                     ph.producible_outputs(n, 0, 0, spec.num, spec.den))
    info = dict(kernel=eng.bspec.kernel, streams=S, lanes=eng.B,
                in_frames_per_launch=q,
                out_frames_per_launch=eng.out_frames_per_launch,
                launches=ran, compile_s=round(compile_s, 3),
                run_s=round(run_s, 3), degraded=eng.degraded)
    if inspect:
        import jax.numpy as jnp
        x = eng._on_lanes(jnp.zeros((eng._step.chunk_rows, eng.B),
                                    jnp.int16))
        info["step"] = inspect_step(eng._step.fn, eng._hist, x, eng._w)
        info["peak_bytes_in_use"] = _mem(eng._hist.devices().pop())
    rec = verdict(phase, got, want, exact=fixed, **info)
    if ran < launches:
        rec.update(ok=False, error=f"only {ran} full launches ran")
    if inspect:
        precisions = info["step"]["f32_dot_precisions"]
        if fixed:
            # the dense int16 dot must stay on integer int8 x int8 -> int32
            # dots (the gather twin multiplies elementwise in int32)
            rec["ok"] &= not precisions and (
                eng.bspec.kernel == "gather" or info["step"]["int8_dots"] > 0)
        else:
            rec["ok"] &= bool(precisions) and all(
                p == "HIGHEST" for p in precisions)
        rec["ok"] &= info["step"]["compiled_tf32_mentions"] == 0
    return (rec, got, eng) if keep_engine else (rec, got)


def phase_flagship(size: Size, seed: int) -> list[dict]:
    """The flagship engine in both universes, every lane compared; the
    step's precision, int8 dots and memory are inspected."""
    return [run_batched(f"flagship {u}", size.streams, *FLAGSHIP,
                        fixed=u == "fixed", launches=size.launches,
                        seed=seed + i, inspect=True)[0]
            for i, u in enumerate(("float", "fixed"))]


FAMILIES = [
    # (name, in_rate, out_rate, quality, fixed, target, max_latency_ms)
    ("48k->44.1k q10", 48000, 44100, 10, False, QUANTUM, None),
    ("24k->48k q5 (group>1)", 24000, 48000, 5, False, QUANTUM, None),
    ("24k->48k q5 fixed", 24000, 48000, 5, True, QUANTUM, None),
    ("44.1k->24k q5 (down)", 44100, 24000, 5, False, QUANTUM, None),
    ("44100->44101 q1 gather", 44100, 44101, 1, False, 44100, None),
    ("44100->44101 q1 gather fixed", 44100, 44101, 1, True, 44100, None),
    ("voip q3 hard 20 ms", 44100, 48000, 3, False, QUANTUM, 20.0),
]


def phase_families(size: Size, seed: int) -> list[dict]:
    """The other geometry families at ``family_streams`` stereo streams."""
    recs = []
    for i, (name, ir, orr, q, fixed, target, lat) in enumerate(FAMILIES):
        rec, _ = run_batched(name, size.family_streams, ir, orr, q,
                             fixed=fixed, launches=size.launches,
                             seed=seed + 10 + i, target=target,
                             max_latency_ms=lat,
                             inspect=name.startswith("44100->44101"))
        recs.append(rec)
    return recs


def phase_fleet(size: Size, seed: int) -> list[dict]:
    """FleetResampler at the flagship: ragged byte pushes, poll,
    pull_bytes, terminal flush; every stream compared with the reference,
    and the native C++ stager must be the one serving."""
    from speex_resampler_tpu.ops import phase as ph
    from speex_resampler_tpu.runtime.fleet import FleetResampler
    from speex_resampler_tpu.runtime.native import NativeStager
    S, C = size.streams, CHANNELS
    t0 = time.perf_counter()
    fleet = FleetResampler(S, C, *FLAGSHIP, target_chunk_frames=QUANTUM)
    compile_s = time.perf_counter() - t0
    q = fleet.bspec.in_per_launch
    rng = np.random.default_rng(seed + 20)
    lengths = size.launches * q + rng.integers(0, q, size=S)
    frames = _pcm(rng, S, int(lengths.max()))
    for s in range(S):
        frames[s, lengths[s]:] = 0
    data = [frames[s, :lengths[s]].astype("<i2").tobytes() for s in range(S)]
    # each stream's bytes in 8 ragged chunks, odd sizes included
    cuts = [np.sort(np.concatenate(
        [[0, len(d)], rng.integers(1, len(d), size=7)])) for d in data]
    parts = [[] for _ in range(S)]
    t0 = time.perf_counter()
    for i in range(8):
        for s in range(S):
            fleet.push_bytes(s, data[s][cuts[s][i]:cuts[s][i + 1]])
        fleet.poll()
        for s in range(S):
            parts[s].append(fleet.pull_bytes(s))
    fleet.flush()
    for s in range(S):
        parts[s].append(fleet.pull_bytes(s))
    run_s = time.perf_counter() - t0
    spec = fleet.spec
    n_out = [ph.producible_outputs(int(n), 0, 0, spec.num, spec.den)
             for n in lengths]
    want = reference(_lanes(frames), spec, max(n_out))
    got_l, want_l = [], []
    for s in range(S):
        got = np.frombuffer(b"".join(parts[s]), "<i2").reshape(-1, C)
        ref = want[s * C:(s + 1) * C, :n_out[s]].T
        if got.shape != ref.shape:
            return [verdict("fleet flagship", got, ref, exact=False,
                            stream=s)]
        got_l.append(got.ravel())
        want_l.append(ref.ravel())
    native = isinstance(fleet._stager, NativeStager)
    rec = verdict("fleet flagship", np.concatenate(got_l),
                  np.concatenate(want_l), exact=False, streams=S,
                  launches=fleet.stats.launches, native_stager=native,
                  compile_s=round(compile_s, 3), run_s=round(run_s, 3),
                  degraded=fleet.degraded)
    rec["ok"] &= native and fleet.stats.launches >= size.launches
    return [rec]


MULTIFLEET_CONFIGS = [FLAGSHIP, (24000, 48000, 5), (48000, 44100, 10),
                      (44100, 24000, 5)]


def phase_multifleet(size: Size, seed: int) -> list[dict]:
    """MultiFleet over 4 rate buckets with a detach, an attach and one
    mid-stream set_stream_rate, every stream compared with a host
    ResamplerCore driven through the same calls."""
    from speex_resampler_tpu.core.resampler import ResamplerCore
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    per, C = size.multifleet_streams, CHANNELS
    rng = np.random.default_rng(seed + 30)
    t0 = time.perf_counter()
    mf = MultiFleet(channels=C, capacity_per_bucket=per + 1,
                    target_chunk_frames=2048)
    # stream id -> list of (config, pcm segment) in feeding order
    feeds: dict[str, list] = {}
    for b, cfg in enumerate(MULTIFLEET_CONFIGS):
        for i in range(per):
            sid = f"b{b}s{i}"
            mf.add_stream(sid, *cfg)
            feeds[sid] = [(cfg, [])]
    compile_s = time.perf_counter() - t0
    quanta = {cfg: mf._buckets[cfg].fleet.bspec.in_per_launch
              for cfg in MULTIFLEET_CONFIGS}
    outs = {sid: [] for sid in feeds}
    ended = "b0s0"
    switched = "b1s0"
    t0 = time.perf_counter()
    for rnd in range(size.launches):
        for sid, segs in feeds.items():
            if sid == ended and rnd > 0:
                continue
            cfg = segs[-1][0]
            x = _pcm(rng, 1, quanta[cfg] + 37 * rnd)[0]
            segs[-1][1].append(x)
            mf.push(sid, x)
        mf.poll()
        for sid in feeds:
            if not (sid == ended and rnd > 0):
                outs[sid].append(mf.pull(sid))
        if rnd == 0:
            mf.end_stream(ended)             # detach: exact tail drain
            outs[ended].append(mf.pull(ended))
            mf.add_stream("fresh", *MULTIFLEET_CONFIGS[0])   # attach
            feeds["fresh"] = [(MULTIFLEET_CONFIGS[0], [])]
            outs["fresh"] = []
            mf.set_stream_rate(switched, *MULTIFLEET_CONFIGS[0])
            feeds[switched].append((MULTIFLEET_CONFIGS[0], []))
    mf.flush()
    for sid in feeds:
        if sid != ended:
            outs[sid].append(mf.pull(sid))
    run_s = time.perf_counter() - t0
    got_l, want_l = [], []
    for sid, segs in feeds.items():
        (ir, orr, q), _ = segs[0]
        core = ResamplerCore(C, ir, orr, ir, orr, q)
        ref = []
        for k, (cfg, xs) in enumerate(segs):
            if k:
                core.set_rate(cfg[0], cfg[1])
                core.set_quality(cfg[2])
            if xs:
                ref.append(core.process_interleaved(np.concatenate(xs),
                                                    10 ** 9))
        ref = np.concatenate(ref) if ref else np.zeros((0, C), np.int16)
        got = np.concatenate(outs[sid])
        # a rate switch may move the end of stream by one output frame
        slack = 1 if len(segs) > 1 else 0
        m = min(len(got), len(ref))
        if abs(len(got) - len(ref)) > slack:
            return [verdict("multifleet 4 buckets", got, ref, exact=False,
                            stream=sid)]
        got_l.append(got[:m].ravel())
        want_l.append(ref[:m].ravel())
    rec = verdict("multifleet 4 buckets", np.concatenate(got_l),
                  np.concatenate(want_l), exact=False, streams=len(feeds),
                  buckets=len(mf._buckets), compile_s=round(compile_s, 3),
                  run_s=round(run_s, 3), degraded=mf.degraded)
    return [rec]


def phase_single_stream(size: Size, seed: int) -> list[dict]:
    """ResamplerCore on the device route (fm.resample_conv) fed 20 ms
    chunks, compared with the order-faithful reference."""
    from speex_resampler_tpu.core.resampler import ResamplerCore
    from speex_resampler_tpu.ops import fir_exact
    ir, orr, q = FLAGSHIP
    chunk = ir // 50
    pcm = _pcm(np.random.default_rng(seed + 40), 1,
               chunk * size.single_chunks)[0]
    core = ResamplerCore(CHANNELS, ir, orr, ir, orr, q, engine="device")
    t0 = time.perf_counter()
    outs = [core.process_interleaved(pcm[:chunk], 10 ** 9)]
    first_s = time.perf_counter() - t0      # includes the compile
    outs += [core.process_interleaved(pcm[i:i + chunk], 10 ** 9)
             for i in range(chunk, len(pcm), chunk)]
    run_s = time.perf_counter() - t0
    got = np.concatenate(outs)
    want = fir_exact.resample_exact(pcm, ir, orr, q)
    m = min(len(got), len(want))
    rec = verdict("single stream device 20 ms", got[:m], want[:m],
                  exact=False, chunks=size.single_chunks,
                  compile_s=round(first_s, 3), run_s=round(run_s, 3))
    if abs(len(got) - len(want)) > 1:
        rec.update(ok=False, error=f"{len(got)} outputs vs {len(want)}")
    return [rec]


def phase_precision(size: Size, seed: int) -> list[dict]:
    """Every f32 dot of the single-stream device step is lowered at
    HIGHEST (the batched dense and gather steps are checked in their own
    phases)."""
    import jax.numpy as jnp
    from speex_resampler_tpu.ops import filter_design as fd
    from speex_resampler_tpu.ops import fir_matmul as fm
    from speex_resampler_tpu.ops import phase as ph
    spec = fd.design_filter(147, 160, 7)
    w = ph.build_padded_weights(spec.phase_table, 147, 160, 0)
    w = np.pad(w, ((0, -w.shape[0] % 147), (0, 0)))
    x = jnp.zeros((CHANNELS, 147 * 8 + w.shape[0]), jnp.float32)
    step = inspect_step(fm.resample_conv, x, jnp.asarray(w), stride=147)
    p = step["f32_dot_precisions"]
    return [{"phase": "single stream step precision", "step": step,
             "ok": bool(p) and all(v == "HIGHEST" for v in p)
             and step["compiled_tf32_mentions"] == 0}]


def phase_four_cards(size: Size, seed: int, devices) -> list[dict]:
    """The lane-sharded engine on a 4-device mesh (shard_map over lanes,
    no collectives) against the host reference and the same engine
    unsharded on one card."""
    import jax
    import jax.numpy as jnp
    from speex_resampler_tpu.utils.parity import lsb_diff
    mesh = jax.sharding.Mesh(np.array(devices[:4]), ("streams",))
    cases = [("flagship float", FLAGSHIP, False, QUANTUM),
             ("flagship fixed", FLAGSHIP, True, QUANTUM),
             ("44100->44101 q1 gather", (44100, 44101, 1), False, 44100)]
    peak0 = [_mem(d) for d in devices[:4]]
    recs = []
    for i, (name, cfg, fixed, target) in enumerate(cases):
        in_use0 = [_mem(d, "bytes_in_use") for d in devices[:4]]
        rec, sharded, eng = run_batched(
            f"4 cards {name}", size.streams, *cfg, fixed=fixed,
            launches=size.launches, seed=seed + 50 + i, target=target,
            mesh=mesh, keep_engine=True)
        h2, y = eng._step.fn(eng._hist, eng._on_lanes(jnp.zeros(
            (eng._step.chunk_rows, eng.B), jnp.int16)), eng._w)
        rec["device_sets"] = [len(h2.sharding.device_set),
                              len(y.sharding.device_set)]
        in_use1 = [_mem(d, "bytes_in_use") for d in devices[:4]]
        del eng, h2, y
        _, single = run_batched(f"1 card {name}", size.streams, *cfg,
                                fixed=fixed, launches=size.launches,
                                seed=seed + 50 + i, target=target)
        max_err, ties, _ = lsb_diff(sharded, single)
        rec.update(vs_unsharded_max_err=max_err, vs_unsharded_ties=ties,
                   bitwise_equal_unsharded=ties == 0)
        rec["ok"] &= rec["device_sets"] == [4, 4]
        rec["ok"] &= (ties == 0) if fixed else max_err <= 1
        if None not in in_use0 + in_use1:
            rec["bytes_in_use_grew"] = all(
                b > a for a, b in zip(in_use0, in_use1))
            rec["ok"] &= rec["bytes_in_use_grew"]
        recs.append(rec)
    peak1 = [_mem(d) for d in devices[:4]]
    if None not in peak0 + peak1:
        grew = all(b > a for a, b in zip(peak0, peak1))
        recs.append({"phase": "4 cards peak_bytes_in_use",
                     "before": peak0, "after": peak1, "ok": grew})
    return recs


def run_phases(size: Size, seed: int, four_cards: bool, devices):
    """Yield each phase's records as the phase completes."""
    if four_cards:
        yield from phase_four_cards(size, seed, devices)
        return
    for phase in (phase_flagship, phase_families, phase_fleet,
                  phase_multifleet, phase_single_stream, phase_precision):
        yield from phase(size, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the lane-sharded path on 4 GPUs")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated PCM")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != EXPECTED_PLATFORM or (args.four_cards
                                             and len(devices) < 4):
        print(f"chip_smoke: needs {4 if args.four_cards else 1} "
              f"{EXPECTED_PLATFORM} device(s); JAX found platform "
              f"{dev.platform!r} ({dev.device_kind}, {len(devices)} "
              "devices)", file=sys.stderr)
        return 2
    from speex_resampler_tpu.utils.gpu_script import (card_info,
                                                      use_compile_cache)
    print(f"card: {card_info()}", flush=True)
    print(f"compile cache: {use_compile_cache(ROOT)}", flush=True)

    failed = []
    for rec in run_phases(SIZE, args.seed, args.four_cards, devices):
        print("phase " + json.dumps(rec, default=str), flush=True)
        if not rec["ok"]:
            failed.append(rec["phase"])
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
