"""Extended differential fuzz campaign vs the compiled reference oracles.

Standalone and time-budgeted — NOT part of CI (CI runs the seeded subset in
tests/test_fuzz_configs.py / test_fuzz_extended.py).  This campaign draws
far wilder configurations than the curated suites:

  - random rate pairs from BOTH the standard-rate pool and arbitrary
    integers in [4000, 192000] (wild reduced num/den, incl. huge-den
    interpolated configs and deep decimation with oversample halving)
  - random RAGGED chunk schedules (1-frame chunks included) through the
    oracle's `chunks` mode (resample.c:988-1030 exercised at every bite
    boundary)
  - `skip_zeros` injected at a random chunk index (resample.c:1200-1206)
  - random TIGHT output capacities through the oracle's `caps` mode
    (per-call consumed/produced counts diffed exactly — the bite/slot
    quantization of resample.c:929-1035 when the capacity binds)
  - mid-stream `set_rate` + `set_quality` switches through the oracle's
    `setrate` mode (magic-sample migration, resample.c:727-782)
  - BOTH numeric universes: float (<= 1 LSB, rare rounding ties) and
    FIXED_POINT (ZERO tolerated mismatches)
  - optionally, the same stream through `BatchedResampler` (dense XLA
    path) cross-checked against the core (chunking-invariance bound)

Usage:
    python experiments/fuzz_campaign.py [--budget-s 900] [--seed 0]
        [--no-batch]

Writes build/fuzz_campaign.json and prints a one-line summary; exit code 1
if any draw violated its bound.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO))

from conftest import ORACLE, ORACLE_FIXED, _build_oracle, lsb_tie_limit  # noqa: E402

# Persistent compile cache: wild-ratio draws are compile-dominated on CPU
# (fresh filter geometry per draw); identical geometries recur within a
# draw's ragged schedule and across seeds, so the cache compounds.
import jax  # noqa: E402

try:
    jax.config.update("jax_compilation_cache_dir",
                      str(REPO / "build" / "jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
except Exception:
    pass

from speex_resampler_tpu.core.resampler import ResamplerCore  # noqa: E402
from speex_resampler_tpu.utils.errors import ResamplerError  # noqa: E402

_STD_RATES = [8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000,
              88200, 96000, 176400, 192000]


def _draw_rate(rng):
    if rng.random() < 0.5:
        return int(rng.choice(_STD_RATES))
    return int(rng.integers(4000, 192001))


def _cap_frames(n, ir, orr, q):
    """Bound a draw's input length by estimated MAC cost so wild-ratio
    configs (huge reduced den -> the core's host-gather fallback, ~100x
    slower per tap than the dense XLA path) stay seconds per draw instead
    of minutes.  Parity bugs need boundary *crossings*, not length."""
    from speex_resampler_tpu.ops.filter_design import QUALITY_MAP
    den = orr // math.gcd(ir, orr)
    taps = QUALITY_MAP[q].base_length * max(1.0, ir / orr)
    cost_per_in = taps * orr / max(ir, 1)
    # Huge reduced den also means fresh per-shape jit compiles dominate,
    # so the frame budget has to be much harsher than the MAC model alone
    # suggests (measured: a den~30k q10 draw at n=5859 still ran ~6 min).
    budget = 2e5 if den > 8000 else 3e7
    if den > 8000 and q >= 8:
        budget = 5e4
    return int(max(400, min(n, budget / max(cost_per_in, 1e-9))))


def _check_both_reject(cfg, exc, run_ours):
    """The reference CAN reject a mid-stream switch: multiply_frac's uint32
    guard fails rescaling samp_frac_num when the new reduced den is huge
    (resample.c:593-603, :1134) and cmd_setrate/cmd_caps die on it.  Parity
    then means OUR switch must raise too (the JS wrapper would throw)."""
    msg = (exc.stderr or b"").decode(errors="replace").strip()
    if "set_rate failed" not in msg and "set_quality failed" not in msg:
        raise exc  # any other oracle death is a harness bug — surface it
    try:
        run_ours()
    except ResamplerError:
        return cfg, True, ""
    return cfg, False, f"oracle rejected switch ({msg}) but ours accepted"


def _lsb_check(ours, golden, max_rate=5e-3):
    """Float-universe bound: max |err| <= 1 LSB, tie rate small.  The rate
    bound is conftest.lsb_tie_limit — the SAME definition CI asserts, so
    campaign and suite verdicts can never disagree on a draw.  Returns
    (ok, detail)."""
    if ours.size != golden.size:
        return False, f"size {ours.size} vs {golden.size}"
    if ours.size == 0:
        return True, ""
    d = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    if d.max() > 1:
        return False, f"max|err|={int(d.max())}"
    ties = int((d > 0).sum())
    limit = lsb_tie_limit(d.size, max_rate)
    if ties > limit:
        return False, (f"{ties} ties over {d.size} exceeds Poisson "
                       f"bound {limit:.1f} at p={max_rate:g}")
    return True, ""


def _exact_check(ours, golden):
    if ours.size != golden.size:
        return False, f"size {ours.size} vs {golden.size}"
    n = int((ours != golden).sum())
    return n == 0, (f"{n} mismatches" if n else "")


# ---------------------------------------------------------------------------
# chunks mode: ragged schedule + optional skip_zeros
# ---------------------------------------------------------------------------

def _oracle_chunks(oracle_bin, tmp, pcm_bytes, ch, ir, orr, q, sched,
                   skip_at):
    inp = tmp / "in.pcm"
    outp = tmp / "out.pcm"
    sp = tmp / "sched.txt"
    inp.write_bytes(pcm_bytes)
    sp.write_text(" ".join(map(str, sched)))
    cmd = [str(oracle_bin), "chunks", str(ch), str(ir), str(orr), str(q),
           str(inp), str(outp), str(sp)]
    if skip_at >= 0:
        cmd.append(str(skip_at))
    subprocess.run(cmd, check=True, capture_output=True)
    return np.fromfile(outp, dtype=np.int16)


def _ours_chunks(frames, ch, ir, orr, q, sched, skip_at, fixed):
    """Mirror oracle.c cmd_chunks exactly: schedule cycling, monotone
    out-capacity growth, skip_zeros before schedule slot skip_at."""
    core = ResamplerCore(ch, ir, orr, ir, orr, q, fixed_point=fixed)
    total = frames.shape[0]
    outs = []
    out_buffer_bytes = 0
    si = 0
    pos = 0
    while pos < total:
        if si == skip_at:
            core.skip_zeros()
        f = min(sched[si % len(sched)], total - pos)
        si += 1
        chunk_bytes = f * ch * 2
        out_buffer_bytes = max(out_buffer_bytes,
                               (chunk_bytes * orr + ir - 1) // ir)
        cap = out_buffer_bytes // ch // 2
        outs.append(core.process_interleaved(frames[pos:pos + f], cap))
        pos += f
    return np.concatenate([o.reshape(-1) for o in outs])


def _iter_chunks(rng, tmp, fixed):
    ir, orr = _draw_rate(rng), _draw_rate(rng)
    if ir == orr and rng.random() < 0.8:
        orr = _draw_rate(rng)
    q = int(rng.integers(0, 11))
    ch = int(rng.integers(1, 3))
    n_sched = int(rng.integers(1, 8))
    sched = [int(rng.choice([1, 7, 160, 733, 1024, 4001,
                             int(rng.integers(1, 3000))]))
             for _ in range(n_sched)]
    skip_at = int(rng.integers(0, 12)) if rng.random() < 0.3 else -1
    # cap BOTH input length and implied output count (keeps extreme
    # upsample draws like 4k->192k from blowing up a CPU iteration)
    n = _cap_frames(int(min(0.4 * ir, 22000, 60000 * ir // orr + 1000)),
                    ir, orr, q)
    frames = rng.integers(-32768, 32768, size=(n, ch)).astype(np.int16)

    cfg = dict(mode="chunks", fixed=fixed, ir=ir, orr=orr, q=q, ch=ch,
               sched=sched, skip_at=skip_at, n=n)
    oracle_bin = ORACLE_FIXED if fixed else ORACLE
    golden = _oracle_chunks(oracle_bin, tmp, frames.tobytes(), ch, ir, orr,
                            q, sched, skip_at)
    ours = _ours_chunks(frames, ch, ir, orr, q, sched, skip_at, fixed)
    ok, detail = (_exact_check if fixed else _lsb_check)(ours, golden)
    return cfg, ok, detail


# ---------------------------------------------------------------------------
# caps mode: capacity-bound accounting differential (per-call consumed/
# produced counts vs the oracle `caps` command; binds forced deliberately)
# ---------------------------------------------------------------------------

def _iter_caps(rng, tmp, fixed):
    sys.path.insert(0, str(REPO / "tests"))
    from test_accounting import _compare, _oracle_caps, _ours_caps

    ir, orr = _draw_rate(rng), _draw_rate(rng)
    if ir == orr:
        orr = ir + 1 if rng.random() < 0.5 else _draw_rate(rng)
    q = int(rng.integers(0, 11))
    ch = int(rng.integers(1, 3))
    use_float = bool(rng.random() < 0.5)
    n = _cap_frames(int(min(0.4 * ir, 16000, 50000 * ir // orr + 800)),
                    ir, orr, q)
    sched = []
    for _ in range(int(rng.integers(2, 7))):
        f = int(rng.choice([1, 37, 159, 160, 161, 320, 1023, 1024,
                            int(rng.integers(1, 2500))]))
        expect = f * orr // ir
        cap = int(rng.choice([0, 1, max(0, expect - 50), expect,
                              expect + 7, 10**6]))
        sched.append((max(f, 1), cap))
    switch = None
    if rng.random() < 0.5:
        switch = (int(rng.integers(1, 8)), _draw_rate(rng),
                  _draw_rate(rng), int(rng.integers(0, 11)))
        n = min(n, _cap_frames(n, switch[1], switch[2], switch[3]))
    cfg = dict(mode="caps", fixed=fixed, ir=ir, orr=orr, q=q, ch=ch,
               use_float=use_float, sched=sched, switch=switch, n=n)
    pcm = rng.integers(-32768, 32768, size=n * ch).astype(np.int16)
    oracle_bin = ORACLE_FIXED if fixed else ORACLE
    try:
        golden = _oracle_caps(oracle_bin, tmp, pcm, ch, ir, orr, q,
                              use_float, sched, switch)
    except subprocess.CalledProcessError as e:
        return _check_both_reject(
            cfg, e, lambda: _ours_caps(pcm, ch, ir, orr, q, use_float,
                                       sched, switch, fixed=fixed))
    ours = _ours_caps(pcm, ch, ir, orr, q, use_float, sched, switch,
                      fixed=fixed)
    try:
        _compare(golden, ours, fixed=fixed, use_float=use_float)
    except AssertionError as e:
        return cfg, False, str(e)
    return cfg, True, ""


# ---------------------------------------------------------------------------
# setrate mode: mid-stream rate/quality switch
# ---------------------------------------------------------------------------

def _oracle_setrate(oracle_bin, tmp, pcm_bytes, ch, cfg0, chunk_frames,
                    switch_chunk, cfg1):
    inp = tmp / "in.pcm"
    outp = tmp / "out.pcm"
    inp.write_bytes(pcm_bytes)
    in0, out0, q0 = cfg0
    in1, out1, q1 = cfg1
    subprocess.run(
        [str(oracle_bin), "setrate", str(ch), str(in0), str(out0), str(q0),
         str(chunk_frames), str(inp), str(outp), str(switch_chunk),
         str(in1), str(out1), str(q1)], check=True, capture_output=True)
    raw = outp.read_bytes()
    outs, pos = [], 0
    while pos < len(raw):
        n = int(np.frombuffer(raw[pos:pos + 4], dtype=np.uint32)[0])
        pos += 4
        outs.append(np.frombuffer(raw[pos:pos + n * ch * 2],
                                  dtype=np.int16))
        pos += n * ch * 2
    return (np.concatenate(outs) if outs
            else np.zeros(0, np.int16))


def _ours_setrate(frames, ch, cfg0, chunk_frames, switch_chunk, cfg1,
                  fixed):
    in0, out0, q0 = cfg0
    in1, out1, q1 = cfg1
    core = ResamplerCore(ch, in0, out0, in0, out0, q0, fixed_point=fixed)
    outs = []
    cur_in, cur_out = in0, out0
    total = frames.shape[0]
    ci = 0
    for pos in range(0, total, chunk_frames):
        if ci == switch_chunk:
            core.set_rate(in1, out1)
            core.set_quality(q1)
            cur_in, cur_out = in1, out1
        ci += 1
        fr = frames[pos:pos + chunk_frames]
        chunk_bytes = fr.shape[0] * ch * 2
        cap = ((chunk_bytes * cur_out + cur_in - 1) // cur_in) // ch // 2
        outs.append(core.process_interleaved(fr, cap + 64))
    return np.concatenate([o.reshape(-1) for o in outs])


def _iter_setrate(rng, tmp, fixed):
    ch = int(rng.integers(1, 3))
    cfg0 = (_draw_rate(rng), _draw_rate(rng), int(rng.integers(0, 11)))
    cfg1 = (_draw_rate(rng), _draw_rate(rng), int(rng.integers(0, 11)))
    chunk_frames = int(rng.integers(100, 2000))
    switch_chunk = int(rng.integers(1, 20))
    max_up = max(cfg0[1] / cfg0[0], cfg1[1] / cfg1[0])
    n = int(min(0.4 * cfg0[0], 20000, 60000 / max_up + 1000))
    n = min(_cap_frames(n, *cfg0), _cap_frames(n, *cfg1))
    # ensure the switch actually happens inside the stream
    switch_chunk = min(switch_chunk, max(1, n // chunk_frames - 1))
    frames = rng.integers(-32768, 32768, size=(n, ch)).astype(np.int16)

    cfg = dict(mode="setrate", fixed=fixed, ch=ch, cfg0=cfg0, cfg1=cfg1,
               chunk_frames=chunk_frames, switch_chunk=switch_chunk, n=n)
    oracle_bin = ORACLE_FIXED if fixed else ORACLE
    try:
        golden = _oracle_setrate(oracle_bin, tmp, frames.tobytes(), ch,
                                 cfg0, chunk_frames, switch_chunk, cfg1)
    except subprocess.CalledProcessError as e:
        return _check_both_reject(
            cfg, e, lambda: _ours_setrate(frames, ch, cfg0, chunk_frames,
                                          switch_chunk, cfg1, fixed))
    ours = _ours_setrate(frames, ch, cfg0, chunk_frames, switch_chunk,
                         cfg1, fixed)
    # magic-drain timing vs capacity may shift <=2 boundary frames between
    # chunks; compare the common prefix (test_state.py's established bound)
    if abs(len(ours) - len(golden)) > 2 * ch:
        return cfg, False, f"len {len(ours)} vs {len(golden)}"
    m = min(len(ours), len(golden))
    ok, detail = (_exact_check if fixed else _lsb_check)(ours[:m],
                                                         golden[:m])
    return cfg, ok, detail


# ---------------------------------------------------------------------------
# batch-engine cross-check (engine vs core, chunking-invariance bound)
# ---------------------------------------------------------------------------

def _iter_batch(rng, tmp, fixed):
    from speex_resampler_tpu.parallel.batch import BatchedResampler

    # The batch engine's launch quantum is a multiple of the reduced num;
    # arbitrary coprime ratios (num ~ 1e5) would demand a ~1e5-frame
    # quantum with a den-sized weight set — legal but minutes of setup per
    # draw, and wild ratios are already covered through the core in the
    # chunks/setrate modes.  Sample the engine's serving domain instead:
    # standard-rate pairs (den <= ~1280), plus an ir->ir+1 probe for the
    # huge-den gather path at low quality (the 44100->44101 family).
    if rng.random() < 0.8:
        ir = int(rng.choice(_STD_RATES))
        orr = int(rng.choice([r for r in _STD_RATES if r != ir]))
        q = int(rng.integers(0, 11))
        n = int(min(0.3 * ir, 9000, 40000 * ir // orr + 500))
    else:
        ir = int(rng.choice([8000, 16000, 24000]))
        orr = ir + int(rng.choice([-1, 1]))
        q = int(rng.integers(0, 3))
        # quantum = num = ir frames here; feed one full launch + a tail so
        # the gather kernel actually fires (not just the flush hand-off)
        n = ir + 2000
    ch = int(rng.integers(1, 3))
    frames = rng.integers(-32768, 32768, size=(2, n, ch)).astype(np.int16)
    cfg = dict(mode="batch", fixed=fixed, ir=ir, orr=orr, q=q, ch=ch, n=n)
    try:
        eng = BatchedResampler(2, ch, ir, orr, q, fixed_point=fixed)
    except ResamplerError as e:
        return cfg, True, f"engine refused cleanly: {e}"
    a = np.concatenate([eng.process(frames), eng.flush()], axis=1)
    cores = []
    for s in range(2):
        core = ResamplerCore(ch, ir, orr, ir, orr, q, fixed_point=fixed)
        cap = (n * orr + ir - 1) // ir + 128
        y = core.process_interleaved(frames[s], cap)
        cores.append(y)
    m = min(a.shape[1], min(c.shape[0] for c in cores))
    ours = a[:, :m].reshape(2, -1)
    golden = np.stack([c[:m].reshape(-1) for c in cores])
    ok, detail = (_exact_check if fixed else _lsb_check)(ours, golden)
    return cfg, ok, detail


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-batch", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print every draw's config and wall time")
    args = ap.parse_args()

    _build_oracle()
    _build_oracle(ORACLE_FIXED, "FIXED_POINT")

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    stats = {"chunks": 0, "caps": 0, "setrate": 0, "batch": 0}
    failures = []
    iters = 0
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        while time.time() - t0 < args.budget_s:
            t_draw = time.time()
            r = rng.random()
            fixed = rng.random() < 0.5
            try:
                if r < 0.4:
                    cfg, ok, detail = _iter_chunks(rng, tmp, fixed)
                elif r < 0.65:
                    cfg, ok, detail = _iter_caps(rng, tmp, fixed)
                elif r < 0.85 or args.no_batch:
                    cfg, ok, detail = _iter_setrate(rng, tmp, fixed)
                else:
                    cfg, ok, detail = _iter_batch(rng, tmp, fixed)
            except Exception as e:  # noqa: BLE001 — record, keep fuzzing
                cfg = {"mode": "?", "fixed": fixed}
                ok, detail = False, f"EXCEPTION {type(e).__name__}: {e}"
            stats[cfg.get("mode", "?")] = stats.get(cfg.get("mode", "?"),
                                                    0) + 1
            iters += 1
            if args.verbose:
                print(f"[{time.time() - t_draw:6.1f}s] {cfg}", flush=True)
            if not ok:
                failures.append({"cfg": cfg, "detail": detail})
                print(f"FAIL {cfg} -> {detail}", flush=True)

    out = {
        "seed": args.seed,
        "budget_s": args.budget_s,
        "elapsed_s": round(time.time() - t0, 1),
        "iterations": iters,
        "by_mode": stats,
        "failures": failures,
    }
    (REPO / "build").mkdir(exist_ok=True)
    (REPO / "build" / "fuzz_campaign.json").write_text(
        json.dumps(out, indent=1, default=str))
    print(json.dumps({k: v for k, v in out.items() if k != "failures"}
                     | {"n_failures": len(failures)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
