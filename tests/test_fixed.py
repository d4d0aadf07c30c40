"""FIXED_POINT numeric universe: bit-exact parity vs the fixed-build oracle.

The reference is a dual build (arch.h:39-67): the shipped WASM uses
FLOATING_POINT, but -DFIXED_POINT selects spx_word16_t = int16 and Q15
integer hot loops (fixed_generic.h:38-109, resample.c:275-316, fixed
branches of :331-496).  This suite pins our fixed universe
(ResamplerCore(fixed_point=True), ops/fixed_math, ops/fir_fixed) against
the reference compiled with -DFIXED_POINT — with ZERO tolerated mismatches:
wrapping int32 accumulation is order-independent, so the fixed universe has
no floating-point tie caveats at all.
"""

import subprocess

import numpy as np
import pytest

from speex_resampler_tpu.core.resampler import ResamplerCore
from speex_resampler_tpu.parallel.batch import BatchedResampler
from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.ops.fixed_math import cubic_coef_fixed

from conftest import AUDIO_TESTS, oracle_process, oracle_tables

import math


def _spec(in_rate, out_rate, quality):
    g = math.gcd(in_rate, out_rate)
    return fd.design_filter(in_rate // g, out_rate // g, quality,
                            fixed_point=True)


def _pcm(fixture_pcm, name, in_rate, channels, seconds=2):
    pcm = fixture_pcm[name][:seconds * in_rate * channels * 2]
    return np.frombuffer(pcm, dtype=np.int16).reshape(-1, channels)


def _ours_process(frames, channels, in_rate, out_rate, quality,
                  chunk_frames=0, skip_zeros=False):
    """Replicates the oracle `process` command's JS-wrapper loop
    (retained growing output capacity, drop-unconsumed)."""
    core = ResamplerCore(channels, in_rate, out_rate, in_rate, out_rate,
                         quality, fixed_point=True)
    if skip_zeros:
        core.skip_zeros()
    total = len(frames)
    cf = chunk_frames if chunk_frames > 0 else total
    outs, outbufsize = [], 0
    for pos in range(0, total, cf):
        fr = frames[pos:pos + cf]
        outbufsize = max(outbufsize,
                         (len(fr) * channels * 2 * out_rate + in_rate - 1)
                         // in_rate)
        outs.append(core.process_interleaved(fr, outbufsize // channels // 2))
    return np.concatenate(outs)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,in_rate,out_rate,channels,quality",
                         AUDIO_TESTS)
def test_fixed_tables_bit_identical(oracle_fixed, name, in_rate, out_rate,
                                    channels, quality):
    meta, table = oracle_tables(oracle_fixed, channels, in_rate, out_rate,
                                quality, dtype=np.int16)
    spec = _spec(in_rate, out_rate, quality)
    assert spec.filt_len == meta["filt_len"]
    assert spec.use_direct == bool(meta["use_direct"])
    assert len(spec.sinc_table) == meta["table_len"]
    assert spec.sinc_table.dtype == np.int16
    assert np.array_equal(spec.sinc_table, table)


def test_fixed_tables_q10_downsample(oracle_fixed):
    """Longest table family: Q10 decimation (oversample halving path)."""
    meta, table = oracle_tables(oracle_fixed, 1, 96000, 8000, 10,
                                dtype=np.int16)
    spec = _spec(96000, 8000, 10)
    assert np.array_equal(spec.sinc_table, table)
    assert spec.oversample == meta["oversample"]


def test_cubic_coef_fixed_identity():
    """Q15 coefficient rows must sum to 32768 after the +1 correction
    (resample.c:313-315) — the DC-preservation invariant."""
    c = cubic_coef_fixed(np.arange(0, 32768, dtype=np.int32))
    s = c.astype(np.int64).sum(axis=-1)
    # interp[2] gets +1 unless it saturated; total is 32768 or 32767
    assert set(np.unique(s)) <= {32767, 32768}


# ---------------------------------------------------------------------------
# Golden outputs (zero mismatches)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,in_rate,out_rate,channels,quality",
                         AUDIO_TESTS)
def test_fixed_matrix_bit_exact(oracle_fixed, fixture_pcm, tmp_path, name,
                                in_rate, out_rate, channels, quality):
    frames = _pcm(fixture_pcm, name, in_rate, channels)
    golden = oracle_process(oracle_fixed, tmp_path, frames.tobytes(),
                            channels, in_rate, out_rate, quality)
    ours = _ours_process(frames, channels, in_rate, out_rate, quality)
    assert np.array_equal(ours.reshape(-1), golden)

    # duration invariant from src/test.ts:38-40
    in_dur = len(frames) / in_rate
    out_dur = len(ours) / out_rate
    assert abs(in_dur - out_dur) < 0.01


@pytest.mark.parametrize("chunk_frames", [160, 641, 2048])
def test_fixed_streaming_bit_exact(oracle_fixed, fixture_pcm, tmp_path,
                                   chunk_frames):
    """Chunked streaming (state carry across launches) stays bit-exact."""
    frames = _pcm(fixture_pcm, "44100hz_test.pcm", 44100, 2)
    golden = oracle_process(oracle_fixed, tmp_path, frames.tobytes(), 2,
                            44100, 48000, 7, chunk_frames=chunk_frames)
    ours = _ours_process(frames, 2, 44100, 48000, 7,
                         chunk_frames=chunk_frames)
    assert np.array_equal(ours.reshape(-1), golden)


def test_fixed_skip_zeros(oracle_fixed, fixture_pcm, tmp_path):
    frames = _pcm(fixture_pcm, "24000hz_mono_test.pcm", 24000, 1)
    golden = oracle_process(oracle_fixed, tmp_path, frames.tobytes(), 1,
                            24000, 48000, 5, skip_zeros=True)
    ours = _ours_process(frames, 1, 24000, 48000, 5, skip_zeros=True)
    assert np.array_equal(ours.reshape(-1), golden)


def test_fixed_float_api(oracle_fixed, fixture_pcm, tmp_path):
    """speex_resampler_process_interleaved_float in the FIXED build:
    float input is WORD2INT'ed into the int16 mem (resample.c:1002), output
    is the int16 result stored to float (:1019-1022)."""
    frames = _pcm(fixture_pcm, "44100hz_test.pcm", 44100, 2, seconds=1)
    # float samples on the ±32768 scale incl. fractional values
    f32 = frames.astype(np.float32) * np.float32(0.7) + np.float32(0.25)
    inp = tmp_path / "in.f32"
    outp = tmp_path / "out.f32"
    f32.tofile(inp)
    subprocess.run([str(oracle_fixed), "processf", "2", "44100", "48000",
                    "7", "0", str(inp), str(outp)], check=True)
    golden = np.fromfile(outp, dtype=np.float32)

    core = ResamplerCore(2, 44100, 48000, 44100, 48000, 7, fixed_point=True)
    cap = (len(f32) * 48000 + 44099) // 44100 + 1
    ours = core.process_interleaved_float(f32, cap)
    assert ours.dtype == np.float32
    assert np.array_equal(ours.reshape(-1), golden)


def test_fixed_setrate_migration(oracle_fixed, fixture_pcm, tmp_path):
    """Mid-stream set_rate + set_quality with magic-sample migration
    (resample.c:727-782) stays bit-exact in the fixed universe."""
    frames = _pcm(fixture_pcm, "44100hz_test.pcm", 44100, 2, seconds=2)
    inp = tmp_path / "in.pcm"
    outp = tmp_path / "out.pcm"
    inp.write_bytes(frames.tobytes())
    chunk, switch = 1000, 20
    subprocess.run([str(oracle_fixed), "setrate", "2", "44100", "48000",
                    "7", str(chunk), str(inp), str(outp), str(switch),
                    "44100", "24000", "5"], check=True)
    raw = outp.read_bytes()
    counts, outs, pos = [], [], 0
    while pos < len(raw):
        n = int(np.frombuffer(raw[pos:pos + 4], dtype=np.uint32)[0])
        pos += 4
        outs.append(np.frombuffer(raw[pos:pos + n * 4], dtype=np.int16))
        pos += n * 4
        counts.append(n)
    golden = np.concatenate(outs)

    core = ResamplerCore(2, 44100, 48000, 44100, 48000, 7, fixed_point=True)
    ours, cur = [], (44100, 48000)
    for idx, pos in enumerate(range(0, len(frames), chunk)):
        if idx == switch:
            core.set_rate(44100, 24000)
            core.set_quality(5)
            cur = (44100, 24000)
        fr = frames[pos:pos + chunk]
        cap = (len(fr) * 2 * 2 * cur[1] + cur[0] - 1) // cur[0] // 4 + 64
        y = core.process_interleaved(fr, cap)
        assert len(y) == counts[idx]
        ours.append(y.reshape(-1))
    assert np.array_equal(np.concatenate(ours), golden)


def test_fixed_direct_output_scale(oracle_fixed, tmp_path):
    """Sanity: direct-path fixed output tracks input scale (Q15 taps sum
    ~cutoff·32768, SATURATE32PSHR(,15) restores sample scale)."""
    t = np.arange(24000, dtype=np.float64) / 24000.0
    tone = (10000 * np.sin(2 * np.pi * 440 * t)).astype(np.int16)[:, None]
    ours = _ours_process(tone, 1, 24000, 48000, 5)
    mid = ours[1000:-1000]
    assert 9000 < np.abs(mid.astype(np.int32)).max() <= 11000


# ---------------------------------------------------------------------------
# Batched device engine (exact int8-plane GEMM formulation)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ir,orr,q", [
    (24000, 48000, 5),    # direct, small den
    (44100, 48000, 7),    # interpolated (4 explicit accumulators)
    (48000, 44100, 10),   # interpolated downsample, long filter
])
def test_fixed_batched_equals_cores(ir, orr, q):
    """BatchedResampler(fixed_point=True) must equal independent fixed
    cores BIT-EXACTLY (not <=1 LSB): the int8-plane decomposition of the
    int16 dot is exact and wrapping int32 sums are order-independent."""
    rng = np.random.default_rng(3)
    S, C, n = 3, 2, 3000
    eng = BatchedResampler(S, C, ir, orr, q, target_chunk_frames=512,
                           fixed_point=True)
    frames = rng.integers(-32768, 32768, size=(S, n, C)).astype(np.int16)
    outs = [eng.process(frames[:, p:p + 997]) for p in range(0, n, 997)]
    outs.append(eng.flush())
    y = np.concatenate(outs, axis=1)
    for s in range(S):
        core = ResamplerCore(C, ir, orr, ir, orr, q, fixed_point=True)
        ref = core.process_interleaved(frames[s], 10 ** 9)
        assert y.shape[1] <= len(ref)
        assert np.array_equal(y[s], ref[:y.shape[1]])


def test_fixed_batched_mesh_sharded():
    """Fixed engine under an 8-device mesh: sharded == unsharded, bit-equal
    (streams are share-nothing; zero collectives)."""
    import jax
    devs = jax.devices("cpu")[:8]
    mesh = jax.sharding.Mesh(np.array(devs), ("streams",))
    rng = np.random.default_rng(11)
    S, C, n = 8, 2, 2048
    frames = rng.integers(-32768, 32768, size=(S, n, C)).astype(np.int16)
    kw = dict(target_chunk_frames=512, fixed_point=True)
    e1 = BatchedResampler(S, C, 44100, 48000, 7, **kw)
    e2 = BatchedResampler(S, C, 44100, 48000, 7, mesh=mesh, **kw)
    y1 = e1.process(frames)
    y2 = e2.process(frames)
    assert y1.shape == y2.shape and np.array_equal(y1, y2)


def test_fixed_batched_checkpoint_roundtrip():
    rng = np.random.default_rng(5)
    S, C = 2, 1
    frames = rng.integers(-32768, 32768, size=(S, 3000, 1)).astype(np.int16)
    e1 = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=512,
                          fixed_point=True)
    y0 = e1.process(frames[:, :1500])
    snap = e1.state_dict()
    ya = e1.process(frames[:, 1500:])
    e2 = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=512,
                          fixed_point=True)
    e2.load_state_dict(snap)
    yb = e2.process(frames[:, 1500:])
    assert np.array_equal(ya, yb)
    # float engine must refuse a fixed snapshot
    e3 = BatchedResampler(S, C, 44100, 48000, 7, target_chunk_frames=512)
    with pytest.raises(Exception):
        e3.load_state_dict(snap)


def _fixed_step_case(ir, orr, q, target, seed, mesh=None):
    """One launch of the fixed dense step on full-range int16 history and
    chunk (wrapping sums exercised) vs the exact host fixed loops; with
    ``mesh`` the step runs lane-sharded and must stay sharded."""
    import jax
    import jax.numpy as jnp
    from speex_resampler_tpu.ops import fir_fixed
    from speex_resampler_tpu.parallel.batch import (_launch_geometry,
                                                    make_batched_step)
    rng = np.random.default_rng(seed)
    spec = _spec(ir, orr, q)
    bspec = _launch_geometry(spec, target)
    assert bspec.kernel == "dense"
    step = make_batched_step(spec, bspec, mesh=mesh)
    B = 16
    n_in = bspec.in_per_launch
    x_np = np.zeros((step.chunk_rows, B), dtype=np.int16)
    x_np[:n_in] = rng.integers(-32768, 32768, (n_in, B)).astype(np.int16)
    h_np = rng.integers(-32768, 32768, (step.hist_rows, B)).astype(np.int16)
    h, x, w = jnp.asarray(h_np), jnp.asarray(x_np), step.w
    if mesh is not None:
        P = jax.sharding.PartitionSpec
        lane = jax.sharding.NamedSharding(mesh, P(None, "streams"))
        h, x = jax.device_put(h, lane), jax.device_put(x, lane)
        w = jax.device_put(w, jax.sharding.NamedSharding(mesh, P()))
    _, y = step.fn(h, x, w)
    if mesh is not None:
        assert len(y.sharding.device_set) == len(mesh.devices.flat)
    X = np.concatenate([h_np[-(spec.filt_len - 1):], x_np[:n_in]], axis=0).T
    ref = fir_fixed.resample_fixed(X, 0, bspec.f0, bspec.out_per_launch,
                                   spec)
    assert np.array_equal(np.asarray(y).T, ref)


@pytest.mark.parametrize("ir,orr,q", [
    (24000, 48000, 5),    # direct: 4 exact int8 dots
    (44100, 48000, 7),    # interpolated: 4 accumulators + integer cubic
])
def test_fixed_dense_step_matches_host_loops(ir, orr, q):
    """The dense fixed step (exact int8 planes + int32 bias) is
    bit-identical to the host fixed hot loops for one launch from a
    full-range random history."""
    _fixed_step_case(ir, orr, q, 600, seed=1)


def test_fixed_api_wrapper(oracle_fixed, fixture_pcm, tmp_path):
    """SpeexResampler(fixed_point=True): the JS-wrapper-compatible API on
    the Q15 universe, bit-exact incl. the Transform byte-carry path."""
    from speex_resampler_tpu import SpeexResampler, SpeexResamplerTransform
    pcm = fixture_pcm["44100hz_test.pcm"][:2 * 44100 * 2 * 2]
    golden = oracle_process(oracle_fixed, tmp_path, pcm, 2, 44100, 48000, 7)
    r = SpeexResampler(2, 44100, 48000, 7, fixed_point=True)
    out = np.frombuffer(r.process_chunk(pcm), dtype=np.int16)
    assert np.array_equal(out, golden)

    # Transform path with byte-misaligned chunks: the carry re-buckets
    # frames into the schedule 1000,1001,1001,1001,... and the JS capacity
    # rule (retained buffer) decides any input drops — so the golden run
    # must use the SAME frame schedule (oracle `chunks` command)
    t = SpeexResamplerTransform(2, 44100, 48000, 7, fixed_point=True)
    outs, step = [], 1000 * 4 + 3
    for pos in range(0, len(pcm), step):
        outs.append(t.transform(pcm[pos:pos + step]))
    got = np.frombuffer(b"".join(outs), dtype=np.int16)

    carry, sched = 0, []
    pos = 0
    while pos < len(pcm):
        take = min(step, len(pcm) - pos)
        pos += take
        carry += take
        sched.append(carry // 4)
        carry %= 4
    inp = tmp_path / "t_in.pcm"
    outp = tmp_path / "t_out.pcm"
    schedp = tmp_path / "sched.txt"
    inp.write_bytes(pcm[:len(pcm) - len(pcm) % 4])
    schedp.write_text(" ".join(map(str, sched)))
    subprocess.run([str(oracle_fixed), "chunks", "2", "44100", "48000",
                    "7", str(inp), str(outp), str(schedp)], check=True)
    golden2 = np.fromfile(outp, dtype=np.int16)
    assert np.array_equal(got, golden2[:len(got)])
    assert len(golden2) - len(got) <= 4  # trailing carry may hold a frame


def test_fixed_cli(oracle_fixed, fixture_pcm, tmp_path):
    from speex_resampler_tpu.cli import main
    pcm = fixture_pcm["24000hz_mono_test.pcm"][:24000 * 2]
    inp, outp = tmp_path / "in.pcm", tmp_path / "o.pcm"
    inp.write_bytes(pcm)
    rc = main(["resample", "-c", "1", "-i", "24000", "-o", "48000",
               "-q", "5", "--fixed-point", str(inp), str(outp)])
    assert rc == 0
    golden = oracle_process(oracle_fixed, tmp_path, pcm, 1, 24000, 48000, 5)
    got = np.fromfile(outp, dtype=np.int16)
    assert np.array_equal(got, golden)


def test_fixed_dense_step_long_cycle():
    """48k->44.1k q10 (den 147, 256-tap interpolated filter, 4
    accumulators): the dense fixed step is bit-identical to the host fixed
    hot loops."""
    _fixed_step_case(48000, 44100, 10, 400, seed=2)


def test_fixed_fleet_and_multifleet():
    """Fleet and MultiFleet serving front-ends in the fixed universe stay
    bit-exact vs independent fixed cores."""
    from speex_resampler_tpu.runtime.fleet import FleetResampler
    from speex_resampler_tpu.runtime.multifleet import MultiFleet
    rng = np.random.default_rng(4)
    S, C, n = 2, 2, 2000
    frames = rng.integers(-32768, 32768, size=(S, n, C)).astype(np.int16)

    fleet = FleetResampler(S, C, 44100, 48000, 7, target_chunk_frames=512,
                           fixed_point=True)
    for s in range(S):
        fleet.push(s, frames[s])
    fleet.poll()
    fleet.flush()
    for s in range(S):
        got = fleet.pull(s)
        core = ResamplerCore(C, 44100, 48000, 44100, 48000, 7,
                             fixed_point=True)
        ref = core.process_interleaved(frames[s], 10 ** 9)
        assert np.array_equal(got, ref[:len(got)]) and len(got) >= \
            len(ref) - 1

    mf = MultiFleet(C, capacity_per_bucket=4, target_chunk_frames=512,
                    fixed_point=True)
    mf.add_stream("a", 44100, 48000, 7)
    mf.push("a", frames[0])
    mf.poll()
    got = [mf.pull("a")]
    got.append(mf.end_stream("a"))
    y = np.concatenate([g for g in got if g is not None and len(g)])
    core = ResamplerCore(C, 44100, 48000, 44100, 48000, 7, fixed_point=True)
    ref = core.process_interleaved(frames[0], 10 ** 9)
    assert np.array_equal(y, ref[:len(y)])


@pytest.mark.parametrize("ir,orr,q,target", [
    (44100, 48000, 7, 147),    # flagship, one output period per launch
    (48000, 44100, 10, 400),   # long weight cycle, 4 accumulators
])
def test_fixed_dense_step_mesh_sharded(ir, orr, q, target):
    """The fixed dense step under shard_map on an 8-device virtual mesh
    keeps the lane axis sharded and stays bit-identical to the host fixed
    loops (share-nothing lanes, exact integer sums)."""
    import jax
    devs = jax.devices("cpu")[:8]
    mesh = jax.sharding.Mesh(np.array(devs), ("streams",))
    _fixed_step_case(ir, orr, q, target, seed=6, mesh=mesh)


def test_resample_gather_fixed_direct_branch():
    """The on-device fixed gather kernel's DIRECT-table branch (reachable
    via full_sinc_table + huge-den configs): wrapping-int32 accumulation +
    SATURATE32PSHR epilogue, bit-identical to the host Q15 algebra."""
    import jax.numpy as jnp
    from speex_resampler_tpu.ops import fir_matmul as fm
    from speex_resampler_tpu.ops.fixed_math import (saturate32pshr,
                                                    to_word16, I32)
    rng = np.random.default_rng(17)
    N, tile, B, T = 16, 2048, 3, 4096
    taps = rng.integers(-32000, 32000, size=(tile, N)).astype(np.int16)
    starts = rng.integers(0, T - N, size=tile).astype(np.int32)
    X = rng.integers(-32768, 32768, size=(B, T)).astype(np.int16)

    got = np.asarray(fm.resample_gather_fixed(
        jnp.asarray(X), jnp.asarray(taps), jnp.asarray(starts), None,
        tile=tile))

    idx = starts[:, None].astype(np.int64) + np.arange(N)[None, :]
    win = X[:, idx].astype(I32)
    with np.errstate(over="ignore"):
        acc = (win * taps[None].astype(I32)).sum(axis=-1, dtype=I32)
    ref = to_word16(saturate32pshr(acc, 15, 32767))
    assert np.array_equal(got, ref)
