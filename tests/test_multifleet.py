"""Heterogeneous fleet manager tests (SURVEY §7 hard part 6)."""

import numpy as np
import pytest

from speex_resampler_tpu.core.resampler import ResamplerCore
from speex_resampler_tpu.runtime.multifleet import MultiFleet
from speex_resampler_tpu.utils.errors import ResamplerError

from conftest import assert_lsb_close


def _ref(frames, in_rate, out_rate, q, skip_tail=False):
    core = ResamplerCore(frames.shape[1], in_rate, out_rate, in_rate,
                         out_rate, q)
    return core.process_interleaved(frames, 10**9)


def test_multifleet_heterogeneous_streams():
    rng = np.random.default_rng(0)
    mf = MultiFleet(channels=2, capacity_per_bucket=4,
                    target_chunk_frames=512)
    cfgs = {"a": (44100, 48000, 7), "b": (24000, 48000, 5),
            "c": (44100, 24000, 5), "d": (44100, 48000, 7)}
    data = {}
    for sid, (ir, orr, q) in cfgs.items():
        mf.add_stream(sid, ir, orr, q)
        data[sid] = (rng.integers(-32768, 32768, size=(6000, 2)) // 2
                     ).astype(np.int16)
    # ragged pushes
    for start in range(0, 6000, 777):
        for sid in cfgs:
            mf.push(sid, data[sid][start:start + 777])
        mf.poll()
    mf.flush()
    for sid, (ir, orr, q) in cfgs.items():
        got = mf.pull(sid)
        ref = _ref(data[sid], ir, orr, q)
        m = min(len(got), len(ref))
        assert got.shape[0] == ref.shape[0], (sid, got.shape, ref.shape)
        assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


def test_multifleet_dynamic_attach_detach():
    rng = np.random.default_rng(1)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256)
    x1 = (rng.integers(-20000, 20000, size=(3000, 1))).astype(np.int16)
    x2 = (rng.integers(-20000, 20000, size=(3000, 1))).astype(np.int16)

    mf.add_stream("s1", 24000, 48000, 5)
    mf.push("s1", x1)
    mf.poll()
    # capacity 2: a second and third stream; third must fail until a slot
    # frees
    mf.add_stream("s2", 24000, 48000, 5)
    with pytest.raises(ResamplerError):
        mf.add_stream("s3", 24000, 48000, 5)

    # end s1, drain, pull -> slot frees -> s3 fits
    mf.end_stream("s1")
    mf.poll()
    got1 = mf.pull("s1")
    ref1 = _ref(x1, 24000, 48000, 5)
    assert got1.shape == ref1.shape
    assert_lsb_close(got1.ravel(), ref1.ravel())

    mf.add_stream("s3", 24000, 48000, 5)
    mf.push("s3", x2)
    mf.push("s2", x2)
    mf.flush()
    ref2 = _ref(x2, 24000, 48000, 5)
    for sid in ("s2", "s3"):
        got = mf.pull(sid)
        assert got.shape == ref2.shape
        assert_lsb_close(got.ravel(), ref2.ravel())


def test_multifleet_exact_output_budget():
    """Zero-padding a drain must not leak extra output frames."""
    rng = np.random.default_rng(2)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=1000)
    n = 1234  # far from the launch quantum
    x = (rng.integers(-20000, 20000, size=(n, 1))).astype(np.int16)
    mf.add_stream("s", 44100, 48000, 7)
    mf.push("s", x)
    mf.end_stream("s")
    mf.poll()
    got = mf.pull("s")
    ref = _ref(x, 44100, 48000, 7)
    assert got.shape == ref.shape
    assert_lsb_close(got.ravel(), ref.ravel())
    # stream record fully gone
    with pytest.raises(ResamplerError):
        mf.pull("s")


def test_multifleet_set_stream_rate():
    """Mid-stream switch now carries filter state exactly (C magic-sample
    semantics): the MultiFleet stream must match a single ResamplerCore
    driven through the same set_rate/set_quality switch."""
    rng = np.random.default_rng(3)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    xa = (rng.integers(-20000, 20000, size=(2500, 1))).astype(np.int16)
    xb = (rng.integers(-20000, 20000, size=(2500, 1))).astype(np.int16)
    mf.add_stream("s", 24000, 48000, 5)
    mf.push("s", xa)
    mf.set_stream_rate("s", 44100, 48000, 7)
    mf.push("s", xb)
    mf.flush()
    got = mf.pull("s")

    core = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    p1 = core.process_interleaved(xa, 10 ** 9)
    core.set_rate(44100, 48000)
    core.set_quality(7)
    p2 = core.process_interleaved(xb, 10 ** 9)
    ref = np.concatenate([p1, p2])
    m = min(got.shape[0], ref.shape[0])
    assert abs(got.shape[0] - ref.shape[0]) <= 1, (got.shape, ref.shape)
    assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


def test_multifleet_set_stream_rate_oracle(oracle, tmp_path):
    """Oracle-pinned: the reference core driven through the identical
    switch scenario (oracle setrate emits per-chunk counts + PCM)."""
    import subprocess
    rng = np.random.default_rng(7)
    n, chunk, switch_at = 8000, 1000, 3
    pcm = (rng.integers(-20000, 20000, size=n)).astype("<i2")
    inp = tmp_path / "in.pcm"
    outp = tmp_path / "out.pcm"
    inp.write_bytes(pcm.tobytes())
    subprocess.run([str(oracle), "setrate", "1", "24000", "48000", "5",
                    str(chunk), str(inp), str(outp), str(switch_at),
                    "44100", "48000", "7"], check=True)
    raw = outp.read_bytes()
    want, off = [], 0
    while off < len(raw):
        cnt = int.from_bytes(raw[off:off + 4], "little")
        off += 4
        want.append(np.frombuffer(raw[off:off + cnt * 2], dtype="<i2"))
        off += cnt * 2
    want = np.concatenate(want)

    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", 24000, 48000, 5)
    frames = pcm.reshape(-1, 1)
    for i in range(0, n, chunk):
        if i // chunk == switch_at:
            mf.set_stream_rate("s", 44100, 48000, 7)
        mf.push("s", frames[i:i + chunk])
        mf.poll()
    mf.flush()
    got = mf.pull("s").ravel()
    m = min(got.shape[0], want.shape[0])
    assert abs(got.shape[0] - want.shape[0]) <= 2, (got.shape, want.shape)
    assert_lsb_close(got[:m], want[:m])


def test_multifleet_remove_stream_drops_staged():
    rng = np.random.default_rng(4)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256)
    x = (rng.integers(-20000, 20000, size=(1000, 1))).astype(np.int16)
    mf.add_stream("s", 24000, 48000, 5)
    mf.add_stream("t", 24000, 48000, 5)
    mf.push("s", x)
    mf.push("t", x)
    mf.poll()
    banked_before = mf.pull("t").shape[0]
    mf.remove_stream("s")
    # slot is free again
    mf.add_stream("u", 24000, 48000, 5)
    assert banked_before > 0


def test_multifleet_switch_to_overflowing_config_is_transactional():
    """Switching to a config the C build rejects outright (update_filter's
    INT_MAX guards on an extreme downsample, resample.c:643-656) must
    raise ResamplerError(OVERFLOW) — not leak filter_design's ValueError —
    and must not touch the stream at all: the destination-bucket
    reservation fails before any teardown, so the lane keeps lockstep
    serving with no transition.  (Found by coverage probing: the eager
    FleetResampler construction for the new bucket leaked
    OverflowArgError past the transactional handling.)"""
    rng = np.random.default_rng(23)
    x1 = (rng.integers(-20000, 20000, size=(2000, 1))).astype(np.int16)
    x2 = (rng.integers(-20000, 20000, size=(2000, 1))).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", 24000, 48000, 5)
    mf.push("s", x1)
    mf.poll()
    with pytest.raises(ResamplerError):
        mf.set_stream_rate("s", 4294967291, 8000)
    assert mf._streams["s"].transition is None   # recovery completed
    assert mf._streams["s"].slot is not None     # lane re-seeded
    mf.push("s", x2)
    mf.poll()
    mf.flush()
    got = mf.pull("s")

    ref = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    want = np.concatenate([ref.process_interleaved(x1, 10 ** 9),
                           ref.process_interleaved(x2, 10 ** 9)])
    assert got.shape == want.shape, (got.shape, want.shape)
    assert_lsb_close(got.ravel(), want.ravel())


def test_multifleet_end_stream_during_live_transition_collects_tail():
    """end_stream while a rate-switch transition is still live (phase not
    yet back to 0) must drain the transition exactly: outputs already
    pumped plus the finish() tail equal the reference core replay."""
    rng = np.random.default_rng(29)
    x1 = (rng.integers(-20000, 20000, size=(1999, 1))).astype(np.int16)
    x2 = (rng.integers(-20000, 20000, size=(3, 1))).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", 44100, 48000, 7)
    mf.push("s", x1)                  # drain leaves a nonzero frac, so the
    mf.set_stream_rate("s", 48000, 44100, 5)   # switch transition is live
    mf.push("s", x2)                  # 3 frames: fewer than k0 outputs
    assert mf._streams["s"].transition is not None
    mf.end_stream("s")
    got = mf.pull("s")

    ref = ResamplerCore(1, 44100, 48000, 44100, 48000, 7)
    p1 = ref.process_interleaved(x1, 10 ** 9)
    ref.set_rate(48000, 44100)
    ref.set_quality(5)
    p2 = ref.process_interleaved(x2, 10 ** 9)
    tail = ref.process_native_interleaved(
        np.zeros((0, 1), np.int16), 10 ** 9)
    want = np.concatenate([p1, p2] + ([tail] if tail.shape[0] else []))
    m = min(got.shape[0], want.shape[0])
    assert abs(got.shape[0] - want.shape[0]) <= 1, (got.shape, want.shape)
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())


@pytest.mark.parametrize("fixed", [False, True])
def test_multifleet_switch_before_any_data_is_unstarted(fixed):
    """set_stream_rate on a stream that never pushed data must follow C's
    UNSTARTED update_filter path (resample.c:721-726): no magic migration,
    no spurious leading outputs — the stream then behaves like a fresh
    resampler at the new config.  (Found by the churn fuzz: the hand-off
    core was seeded via import_history, which forces started=1 and emitted
    ~filt_len/2 magic-drain frames of zero history.)"""
    rng = np.random.default_rng(5)
    data = (rng.integers(-32768, 32768, size=(1761, 1)) // 2).astype(
        np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=300,
                    fixed_point=fixed)
    mf.add_stream("s", 44100, 48000, 7)
    mf.set_stream_rate("s", 24000, 48000, 5)   # before ANY push
    mf.push("s", data)
    mf.end_stream("s")
    got = mf.pull("s")

    core = ResamplerCore(1, 24000, 48000, 24000, 48000, 5,
                         fixed_point=fixed)
    ref = core.process_interleaved(data, 10 ** 9)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if fixed:
        assert np.array_equal(got, ref)
    else:
        assert_lsb_close(got.ravel(), ref.ravel())


@pytest.mark.parametrize("seed", [42, 1337])
@pytest.mark.parametrize("fixed", [False, True])
def test_multifleet_fuzz_churn(fixed, seed):
    """Randomized attach/push/push_bytes/poll/switch/end/pull/checkpoint
    churn: every pulled sample must match a per-stream reference core fed
    the same data (with set_rate/set_quality applied at the same points in
    the stream).  In the fixed universe the value match is bit-exact (zero
    tolerance); output counts may differ by at most one frame per live
    switch (the same boundary quantization the dedicated switch tests
    tolerate)."""
    _run_churn(fixed, seed, watermarks=False)


@pytest.mark.parametrize("seed", [7, 2024])
@pytest.mark.parametrize("fixed", [False, True])
def test_multifleet_fuzz_churn_with_watermarks(fixed, seed):
    """The same churn under tight backpressure watermarks: pushes are
    randomly REFUSED (ALLOC_FAILED) at staging/banked/carryover bounds,
    including mid-transition and through checkpoint round-trips.  Pins
    the atomicity contract — a refused push changes nothing (no lost or
    duplicated frames, byte carries intact) — and that ``writable()``
    mirrors every refusal.  Accepted data must replay sample-exactly."""
    _run_churn(fixed, seed, watermarks=True)


def _run_churn(fixed, seed, watermarks):
    rng = np.random.default_rng(seed)
    wm = dict(max_staged_frames=1200, max_banked_frames=900) \
        if watermarks else {}
    mf = MultiFleet(channels=1, capacity_per_bucket=3,
                    target_chunk_frames=300,
                    fixed_point=fixed, **wm)
    configs = [(24000, 48000, 5), (44100, 48000, 7), (48000, 24000, 4)]
    refusals = 0

    live = {}      # sid -> [cfg, pushed_chunks_and_switch_markers]
    collected = {}  # sid -> [pulled arrays]
    done = {}      # sid -> (cfg, all_pushed)
    next_id = 0

    pending = {}   # sid -> carried partial-frame bytes (mirror model)

    def record_frames(sid, frames):
        items = live[sid][1]
        if items and isinstance(items[-1], np.ndarray):
            items[-1] = np.concatenate([items[-1], frames])
        else:
            items.append(frames)

    for step in range(300):
        op = rng.choice(["add", "push", "poll", "switch", "end", "pull",
                         "ckpt", "push_bytes"],
                        p=[0.1, 0.27, 0.2, 0.05, 0.1, 0.15, 0.03, 0.10])
        if op == "push_bytes" and live:
            # ragged byte pushes: partial frames carry across calls AND
            # across rate switches (the salvage path); mirror the carry
            # byte-for-byte so the reference replay sees the same frames
            sid = list(live)[int(rng.integers(len(live)))]
            nb = int(rng.integers(1, 700))
            data = rng.integers(0, 256, size=nb, dtype=np.uint8).tobytes()
            whole = pending.get(sid, b"") + data
            try:
                mf.push_bytes(sid, data)
            except ResamplerError:
                # refusal atomicity: the engine took NOTHING, so the
                # mirror records nothing; writable() must agree
                refusals += 1
                assert watermarks
                assert not mf.writable(sid, len(whole) // 2)
                continue
            keep = len(whole) - len(whole) % 2
            pending[sid] = whole[keep:]
            if keep:
                record_frames(sid, np.frombuffer(
                    whole[:keep], dtype="<i2").reshape(-1, 1))
            continue
        if op == "ckpt":
            # full-engine checkpoint round-trip mid-churn (through pickle,
            # so the snapshot must be genuinely serializable): the
            # restored engine must continue identically
            import pickle
            snap = pickle.loads(pickle.dumps(mf.state_dict()))
            mf2 = MultiFleet(channels=1, capacity_per_bucket=3,
                             target_chunk_frames=300,
                             fixed_point=fixed, **wm)
            mf2.load_state_dict(snap)
            mf = mf2
            continue
        if op == "add" and len(live) < 6:
            cfg = configs[int(rng.integers(len(configs)))]
            sid = f"s{next_id}"
            next_id += 1
            try:
                mf.add_stream(sid, *cfg)
            except Exception:
                continue
            live[sid] = [cfg, []]
            collected[sid] = []
        elif op == "push" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            n = int(rng.integers(10, 600))
            data = (rng.integers(-32768, 32768, size=(n, 1)) // 2
                    ).astype(np.int16)
            try:
                mf.push(sid, data)
            except ResamplerError:
                refusals += 1
                assert watermarks
                assert not mf.writable(sid, n)
                continue
            live[sid][1].append(data)
        elif op == "poll":
            mf.poll()
        elif op == "switch" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            new_cfg = configs[int(rng.integers(len(configs)))]
            try:
                mf.set_stream_rate(sid, *new_cfg)
            except ResamplerError:
                continue  # target bucket full: transactional no-op
            live[sid][1].append(("switch", new_cfg))
        elif op == "end" and live:
            sid = list(live)[int(rng.integers(len(live)))]
            cfg, chunks = live.pop(sid)
            mf.end_stream(sid)
            done[sid] = (cfg, chunks)
        elif op == "pull":
            pool = list(live) + [s for s in done if s in mf._streams]
            if not pool:
                continue
            sid = pool[int(rng.integers(len(pool)))]
            out = mf.pull(sid)
            if out.shape[0]:
                collected[sid].append(out)

    # finish everything
    for sid in list(live):
        cfg, chunks = live.pop(sid)
        mf.end_stream(sid)
        done[sid] = (cfg, chunks)
    for sid in list(done):
        if sid in mf._streams:
            out = mf.pull(sid)
            if out.shape[0]:
                collected[sid].append(out)

    checked = 0
    for sid, (cfg, items) in done.items():
        got = (np.concatenate(collected[sid])
               if collected.get(sid) else np.zeros((0, 1), np.int16))
        chunks = [it for it in items if isinstance(it, np.ndarray)]
        n_switch = len(items) - len(chunks)
        if not chunks:
            # switches alone push no data; the transition may drain a few
            # zero-history magic frames, the replay's tail drain matches
            if n_switch == 0:
                assert got.shape[0] == 0
                continue
        ir, orr, q = cfg
        core = ResamplerCore(1, ir, orr, ir, orr, q, fixed_point=fixed)
        parts = []
        for it in items:
            if isinstance(it, np.ndarray):
                parts.append(core.process_interleaved(it, 10**9))
            else:
                nir, norr, nq = it[1]
                core.set_rate(nir, norr)
                core.set_quality(nq)
        # end_stream's transition.finish() drains residual magic through
        # the native layer; mirror it (a no-op when no switch left magic)
        tail = core.process_native_interleaved(
            np.zeros((0, 1), np.int16), 10**9)
        if tail.shape[0]:
            parts.append(tail)
        ref = (np.concatenate(parts) if parts
               else np.zeros((0, 1), np.int16))
        if n_switch == 0:
            assert got.shape == ref.shape, (sid, got.shape, ref.shape)
        else:
            # one frame of boundary quantization per live switch (the
            # bound the dedicated switch tests pin)
            assert abs(got.shape[0] - ref.shape[0]) <= n_switch, (
                sid, n_switch, got.shape, ref.shape)
        m = min(got.shape[0], ref.shape[0])
        if fixed:
            assert np.array_equal(got[:m], ref[:m]), sid
        else:
            assert_lsb_close(got[:m].ravel(), ref[:m].ravel())
        checked += 1
    assert checked >= 5  # the fuzz actually exercised streams
    if watermarks:
        assert refusals > 0, "watermarks were never hit"


@pytest.mark.parametrize("fixed", [False, True])
def test_multifleet_end_stream_history_handoff(fixed):
    """end_stream's core hand-off after a real launch: the lane's filter
    history (exactly filt_len-1 rows) seeds a single-stream core that
    drains the staged tail; the whole stream equals one core's run (and
    is bit-exact in the fixed universe)."""
    rng = np.random.default_rng(7)
    x = (rng.integers(-20000, 20000, size=(2500, 1))).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512, fixed_point=fixed)
    mf.add_stream("s", 44100, 48000, 7)
    mf.push("s", x)
    assert mf.poll() > 0
    mf.end_stream("s")
    got = mf.pull("s")
    core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7,
                         fixed_point=fixed)
    ref = core.process_interleaved(x, 10**9)
    assert got.shape == ref.shape
    if fixed:
        assert np.array_equal(got, ref)
    else:
        assert_lsb_close(got.ravel(), ref.ravel())


def test_multifleet_set_stream_rate_full_target_bucket():
    """A rate switch into a full bucket must fail up front and leave the
    stream intact (previously the sid was popped before ALLOC_FAILED,
    losing the drained carryover)."""
    mf = MultiFleet(channels=1, capacity_per_bucket=1,
                    target_chunk_frames=64)
    mf.add_stream("a", 24000, 48000, 5)
    mf.add_stream("b", 44100, 48000, 7)   # fills the 44.1k bucket
    rng = np.random.default_rng(5)
    x = (rng.integers(-1000, 1000, size=(500, 1))).astype(np.int16)
    mf.push("a", x)
    mf.poll()
    with pytest.raises(ResamplerError):
        mf.set_stream_rate("a", 44100, 48000, 7)
    # stream "a" survives under its old config with its output intact
    mf.push("a", x)
    mf.poll()
    mf.end_stream("a")
    out = mf.pull("a")
    core = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    want = core.process_interleaved(np.concatenate([x, x]), 10**9)
    assert_lsb_close(out.ravel(), want.ravel())

    # same-bucket switch is always allowed even when the bucket is full
    mf.set_stream_rate("b", 44100, 48000, 7)
    mf.push("b", x)
    mf.flush()
    assert mf.pull("b").shape[0] > 0


def test_multifleet_transition_pull_is_clean():
    """While a rate switch is pending (reserved slot inactive), pull() must
    NOT surface frames banked by other streams' launches in the new bucket
    (round-2 review finding: stale-history convolution garbage)."""
    rng = np.random.default_rng(11)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("a", 44100, 48000, 7)
    mf.add_stream("b", 24000, 48000, 5)
    x = (rng.integers(-20000, 20000, size=(3000, 1))).astype(np.int16)
    mf.push("b", x[:100])
    mf.set_stream_rate("b", 44100, 48000, 7)   # b now mid-transition
    drained = mf.pull("b")                     # old-config drain only
    mf.push("a", x)                            # a runs launches in bucket
    mf.poll()
    assert mf.pull("b").shape[0] == 0          # no garbage for b
    # a's own output is unaffected
    core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7)
    mf.end_stream("a")
    want = core.process_interleaved(x, 10**9)
    got = mf.pull("a")
    m = min(len(got), len(want))
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())
    # b's drained prefix equals the old-config reference
    core_b = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    want_b = core_b.process_interleaved(x[:100], 10**9)
    assert_lsb_close(drained.ravel(), want_b.ravel())


def test_multifleet_set_stream_rate_preserves_byte_carry():
    """A pending half-frame byte in the stager must survive the switch
    (round-2 review finding: deactivation cleared it, byte-shifting all
    later audio)."""
    rng = np.random.default_rng(12)
    pcm = (rng.integers(-20000, 20000, size=4000)).astype("<i2").tobytes()
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", 24000, 48000, 5)
    mf.push_bytes("s", pcm[:101])              # 1 carry byte pending
    mf.set_stream_rate("s", 44100, 48000, 7)
    mf.push_bytes("s", pcm[101:])
    mf.flush()
    got = mf.pull("s")

    core = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    p1 = core.process_interleaved(
        np.frombuffer(pcm[:100], dtype="<i2").reshape(-1, 1), 10**9)
    core2 = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    # reference: 50 frames under old config, rest under new, carrying state
    ref = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    frames = np.frombuffer(pcm, dtype="<i2").reshape(-1, 1)
    q1 = ref.process_interleaved(frames[:50], 10**9)
    ref.set_rate(44100, 48000)
    ref.set_quality(7)
    q2 = ref.process_interleaved(frames[50:], 10**9)
    want = np.concatenate([q1, q2])
    m = min(len(got), len(want))
    assert abs(len(got) - len(want)) <= 1
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())


def test_multifleet_set_stream_rate_fixed_oracle(oracle_fixed, tmp_path):
    """FIXED universe: the mid-stream rate/quality switch stays BIT-EXACT
    (zero mismatches) vs the fixed oracle driven through the identical
    setrate scenario — magic-sample migration included."""
    import subprocess
    rng = np.random.default_rng(9)
    n, chunk, switch_at = 8000, 1000, 3
    pcm = (rng.integers(-20000, 20000, size=n)).astype("<i2")
    inp = tmp_path / "in.pcm"
    outp = tmp_path / "out.pcm"
    inp.write_bytes(pcm.tobytes())
    subprocess.run([str(oracle_fixed), "setrate", "1", "24000", "48000",
                    "5", str(chunk), str(inp), str(outp), str(switch_at),
                    "44100", "48000", "7"], check=True)
    raw = outp.read_bytes()
    want, off = [], 0
    while off < len(raw):
        cnt = int.from_bytes(raw[off:off + 4], "little")
        off += 4
        want.append(np.frombuffer(raw[off:off + cnt * 2], dtype="<i2"))
        off += cnt * 2
    want = np.concatenate(want)

    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512,
                    fixed_point=True)
    mf.add_stream("s", 24000, 48000, 5)
    frames = pcm.reshape(-1, 1)
    for i in range(0, n, chunk):
        if i // chunk == switch_at:
            mf.set_stream_rate("s", 44100, 48000, 7)
        mf.push("s", frames[i:i + chunk])
        mf.poll()
    mf.flush()
    got = mf.pull("s").ravel()
    m = min(got.shape[0], want.shape[0])
    assert abs(got.shape[0] - want.shape[0]) <= 2, (got.shape, want.shape)
    assert np.array_equal(got[:m], want[:m])


def test_multifleet_end_stream_then_pull_returns_tail_or_empty():
    """The documented sequence — end_stream then pull — must work even
    when the stream owes nothing: pull returns an empty array (and only
    then is the record collected); a second end_stream is a no-op.
    Regression: _gc ran inside end_stream, so pull raised INVALID_ARG."""
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("a", 44100, 48000, 7)
    mf.end_stream("a")            # nothing ever pushed
    mf.end_stream("a")            # repeat is a no-op, not an error
    out = mf.pull("a")
    assert out.shape == (0, 1)
    with pytest.raises(ResamplerError):
        mf.pull("a")              # collected after the post-end pull


def test_multifleet_rejected_switch_keeps_stream_serviceable():
    """A reference-rejected switch (multiply_frac's uint32 guard rescaling
    samp_frac_num, resample.c:593-603/:1134) must raise AND leave the
    stream serving under its OLD config — transactional, unlike C's
    half-committed state (which ResamplerCore reproduces for parity; a
    fleet lane cannot).  Regression: the lane was torn down before the
    switch was attempted, wedging the stream (next push crashed)."""
    # Old config with a HUGE den (44100->65537, coprime) so a live frac
    # can overflow the rescale to a sane new den: multiply_frac's guard
    # fails once frac * 131071 exceeds uint32.  Find a push count whose
    # sub-quantum drain leaves frac >= 2^32/131071 = 32768 (analytically —
    # one-shot from phase 0: f = (out * num) % den).
    from speex_resampler_tpu.ops import filter_design as fd
    from speex_resampler_tpu.ops import phase as ph
    old, bad = (44100, 65537), (44100, 131071)
    num, den = old
    n = None
    for cand in range(150, 600):
        out = ph.producible_outputs(cand, 0, 0, num, den)
        f = (out * num) % den
        try:
            fd.multiply_frac(f, bad[1], den)
        except fd.OverflowArgError:
            n = cand
            break
    assert n is not None

    rng = np.random.default_rng(17)
    x1 = (rng.integers(-20000, 20000, size=(n, 1))).astype(np.int16)
    x2 = (rng.integers(-20000, 20000, size=(2000, 1))).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", *old, 4)
    mf.push("s", x1)
    with pytest.raises(ResamplerError):
        mf.set_stream_rate("s", *bad)
    mf.push("s", x2)              # stream still serviceable, OLD config
    mf.flush()
    got = mf.pull("s")

    ref = ResamplerCore(1, *old, *old, 4)
    want = np.concatenate([ref.process_interleaved(x1, 10 ** 9),
                           ref.process_interleaved(x2, 10 ** 9)])
    assert abs(got.shape[0] - want.shape[0]) <= 1, (got.shape, want.shape)
    m = min(got.shape[0], want.shape[0])
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())


def test_multifleet_switch_magic_covers_windows():
    """A q10→q0 switch right after a sub-quantum push leaves the transition
    with a magic stash whose windows cover all of its first outputs
    (``n_give == 0``) and ``end_stream`` must then drain the stash with NO
    further input.  Both require the core's NATIVE layer: the staging
    entry (the float build's process_int) processes nothing — not even
    magic — on an empty-input call.  Regression: pump() died on its own
    assert; finish() silently stranded the magic tail.

    Reference anchor (non-circular): the float-sample entry is the float
    build's NATIVE-word entry (resample.c:924-963) and drains magic on an
    empty-input call; its outputs pass through the same accumulators, so
    WORD2INT(float entry) == int path bit-for-bit."""
    from speex_resampler_tpu.ops.convert import word2int

    rng = np.random.default_rng(21)
    x = rng.integers(-20000, 20000, size=(300, 1)).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    mf.add_stream("s", 44100, 48000, 10)
    mf.push("s", x)
    mf.set_stream_rate("s", 44100, 48000, 0)  # q10 filt_len -> big magic
    mf.end_stream("s")                        # drain with an empty buffer
    mf.flush()
    got = mf.pull("s")

    core = ResamplerCore(1, 147, 160, 44100, 48000, 10)
    p1 = core.process_interleaved(x, 10 ** 9)
    core.set_quality(0)
    empty = np.zeros((0, 1), dtype=np.float32)
    p2 = np.asarray(word2int(
        core.process_interleaved_float(empty, 10 ** 9)))
    assert p2.shape[0] > 0          # the stash really does render outputs
    assert int(core.magic_samples[0]) == 0
    ref = np.concatenate([p1, p2])
    m = min(got.shape[0], ref.shape[0])
    assert abs(got.shape[0] - ref.shape[0]) <= 1, (got.shape, ref.shape)
    assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


def test_process_native_interleaved_matches_entry():
    """The native-layer interface must agree with the public int entry on
    any call the entry CAN express (non-binding capacity, fresh input):
    same outputs, same state evolution."""
    rng = np.random.default_rng(5)
    x = rng.integers(-20000, 20000, size=(1500, 2)).astype(np.int16)
    a = ResamplerCore(2, 147, 160, 44100, 48000, 7)
    b = ResamplerCore(2, 147, 160, 44100, 48000, 7)
    for lo in range(0, 1500, 300):
        ya = a.process_interleaved(x[lo:lo + 300], 10 ** 9)
        yb = b.process_native_interleaved(x[lo:lo + 300], 10 ** 9)
        np.testing.assert_array_equal(ya, yb)
    assert a.state_dict()["last_sample"].tolist() == \
        b.state_dict()["last_sample"].tolist()


def test_multifleet_chained_rate_switch_mid_transition():
    """Switching again while a transition is live must not drop the frames
    the old transition retained: they were pushed under the intermediate
    config and must be processed under it before the chained set_rate."""
    rng = np.random.default_rng(13)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=512)
    xa = rng.integers(-20000, 20000, size=(100, 1)).astype(np.int16)
    xb = rng.integers(-20000, 20000, size=(3, 1)).astype(np.int16)
    xc = rng.integers(-20000, 20000, size=(2000, 1)).astype(np.int16)
    mf.add_stream("s", 24000, 48000, 5)
    mf.push("s", xa)
    mf.set_stream_rate("s", 44100, 48000, 7)
    mf.push("s", xb)            # tiny push: retained by the live transition
    mf.set_stream_rate("s", 48000, 48000, 5)   # chained switch
    mf.push("s", xc)
    mf.flush()
    got = mf.pull("s")

    core = ResamplerCore(1, 24000, 48000, 24000, 48000, 5)
    p1 = core.process_interleaved(xa, 10 ** 9)
    core.set_rate(44100, 48000)
    core.set_quality(7)
    p2 = core.process_interleaved(xb, 10 ** 9)
    core.set_rate(48000, 48000)
    core.set_quality(5)
    p3 = core.process_interleaved(xc, 10 ** 9)
    ref = np.concatenate([p1, p2, p3])
    m = min(got.shape[0], ref.shape[0])
    assert abs(got.shape[0] - ref.shape[0]) <= 2, (got.shape, ref.shape)
    assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


@pytest.mark.parametrize("fixed", [False, True])
def test_multifleet_push_free_chained_rate_switch(fixed):
    """Two set_stream_rate calls with NO push in between, while the first
    switch left a magic stash (filter shrink, resample.c:746-765): C runs
    no process call under the intermediate config, so the stash must stay
    stashed and migrate through the chained set_rate's update_filter — NOT
    be force-drained as output under the intermediate filter.  (Found by
    the watermark churn fuzz, seed 2024: the pre-fix code called
    transition.finish() unconditionally at the chained switch.)"""
    rng = np.random.default_rng(2024)
    xa = (rng.integers(-32768, 32768, size=(500, 1)) // 2).astype(np.int16)
    xc = (rng.integers(-32768, 32768, size=(2000, 1)) // 2).astype(np.int16)
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256,
                    fixed_point=fixed)
    mf.add_stream("s", 44100, 48000, 7)
    mf.push("s", xa)
    mf.poll()
    mf.set_stream_rate("s", 48000, 24000, 4)   # q7 -> q4 shrinks the filter
    st = mf._streams["s"]
    assert st.transition is not None and not st.transition.fed
    assert int(st.transition.core.magic_samples[0]) > 0, \
        "precondition lost: the first switch no longer stashes magic"
    mf.set_stream_rate("s", 24000, 48000, 5)   # chained, push-free
    mf.push("s", xc)
    mf.flush()
    got = mf.pull("s")

    core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7,
                         fixed_point=fixed)
    p1 = core.process_interleaved(xa, 10 ** 9)
    core.set_rate(48000, 24000)
    core.set_quality(4)
    core.set_rate(24000, 48000)                # no process in between
    core.set_quality(5)
    p3 = core.process_interleaved(xc, 10 ** 9)
    ref = np.concatenate([p1, p3])
    m = min(got.shape[0], ref.shape[0])
    assert abs(got.shape[0] - ref.shape[0]) <= 2, (got.shape, ref.shape)
    if fixed:
        assert np.array_equal(got[:m], ref[:m])
    else:
        assert_lsb_close(got[:m].ravel(), ref[:m].ravel())


def test_idle_bucket_lru_eviction_and_rebuild():
    """Bucket memory is bounded under config churn: a bucket whose last
    stream detaches joins an idle LRU, the oldest beyond max_idle_buckets
    is released, and a config that returns later transparently rebuilds
    its bucket and serves correctly."""
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256,
                    max_idle_buckets=2)
    rng = np.random.default_rng(7)
    x = (rng.integers(-32768, 32768, size=(900, 1)) // 2).astype(np.int16)
    configs = [(44100, 48000, 7), (24000, 48000, 5),
               (48000, 44100, 4), (32000, 48000, 3)]
    def run_one(sid, ir, orr, q):
        mf.add_stream(sid, ir, orr, q)
        mf.push(sid, x)
        mf.poll()
        mf.end_stream(sid)          # exact sub-quantum drain
        got = mf.pull(sid)          # collects tail; record gc's
        core = ResamplerCore(1, ir, orr, ir, orr, q)
        want = core.process_interleaved(x, 10 ** 9)
        m = min(got.shape[0], want.shape[0])
        assert m > 0
        assert_lsb_close(got[:m].ravel(), want[:m].ravel())

    for i, (ir, orr, q) in enumerate(configs):
        run_one(f"s{i}", ir, orr, q)
        assert len(mf._buckets) <= 2, (i, list(mf._buckets))
    # an evicted config returns: bucket rebuilds transparently
    run_one("again", *configs[0])


def test_idle_bucket_default_bound_and_opt_out():
    """Default max_idle_buckets bounds bucket count; None keeps every
    bucket (pre-knob behavior)."""
    assert MultiFleet(channels=1).max_idle_buckets is not None
    mf = MultiFleet(channels=1, capacity_per_bucket=1,
                    target_chunk_frames=256,
                    max_idle_buckets=None)
    for i, orr in enumerate((48000, 24000, 32000)):
        sid = f"k{i}"
        mf.add_stream(sid, 44100, orr, 4)
        mf.end_stream(sid)
        mf.pull(sid)
    assert len(mf._buckets) == 3  # opt-out: all retained


def test_occupied_bucket_never_evicted():
    """Only fully-unoccupied buckets are eviction candidates; live
    streams pin their bucket regardless of churn around them."""
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256,
                    max_idle_buckets=1)
    rng = np.random.default_rng(9)
    x = (rng.integers(-32768, 32768, size=(700, 1)) // 2).astype(np.int16)
    mf.add_stream("live", 44100, 48000, 7)
    mf.push("live", x[:300])
    live_key = (44100, 48000, 7)
    for i, orr in enumerate((24000, 32000, 16000)):
        sid = f"churn{i}"
        mf.add_stream(sid, 44100, orr, 4)
        mf.end_stream(sid)
        mf.pull(sid)
        assert live_key in mf._buckets
    mf.push("live", x[300:])
    mf.flush()
    got = mf.pull("live")
    core = ResamplerCore(1, 44100, 48000, 44100, 48000, 7)
    want = core.process_interleaved(x, 10 ** 9)
    m = min(got.shape[0], want.shape[0])
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())


def test_same_key_rate_switch_with_zero_idle_cap():
    """max_idle_buckets=0 + a same-key set_stream_rate: _drop_slot
    momentarily empties the destination bucket the switch is about to
    re-occupy; without pinning, the eviction sweep deleted it out from
    under the caller and _seed_from_transition raised KeyError (advisor
    round-4 medium finding).  The switch must succeed and the stream
    stay exactly serviceable."""
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256,
                    max_idle_buckets=0)
    rng = np.random.default_rng(21)
    x = (rng.integers(-32768, 32768, size=(700, 1)) // 2).astype(np.int16)
    key = (44100, 48000, 7)
    mf.add_stream("s", *key)
    mf.push("s", x[:300])
    mf.poll()
    mf.set_stream_rate("s", *key[:2], key[2])   # identical config
    assert key in mf._buckets
    mf.push("s", x[300:])
    mf.poll()
    mf.end_stream("s")
    got = mf.pull("s")
    # a same-key "switch" still round-trips through the core hand-off,
    # which is exact: total output equals the uninterrupted reference
    core = ResamplerCore(1, *key[:2], *key[:2], key[2])
    want = core.process_interleaved(x, 10 ** 9)
    m = min(got.shape[0], want.shape[0])
    assert m > 0
    assert_lsb_close(got[:m].ravel(), want[:m].ravel())


def test_stale_idle_entry_never_evicts_occupied_bucket():
    """A bucket re-occupied through the rate-switch fast path (free.pop
    without _bucket_for) used to leave a stale idle entry; a later sweep
    could delete the OCCUPIED bucket.  The sweep must drop stale entries
    instead of live buckets."""
    mf = MultiFleet(channels=1, capacity_per_bucket=2,
                    target_chunk_frames=256,
                    max_idle_buckets=1)
    rng = np.random.default_rng(22)
    x = (rng.integers(-32768, 32768, size=(400, 1)) // 2).astype(np.int16)
    key = (44100, 48000, 7)
    mf.add_stream("s", *key)
    mf.push("s", x)
    mf.poll()
    mf.set_stream_rate("s", *key[:2], key[2])   # same-key: frees_own path
    # churn other configs through the idle list to trigger sweeps
    for i, orr in enumerate((24000, 32000, 16000)):
        sid = f"churn{i}"
        mf.add_stream(sid, 44100, orr, 4)
        mf.end_stream(sid)
        mf.pull(sid)
        assert key in mf._buckets, "occupied bucket evicted via stale entry"
    mf.push("s", x)
    mf.poll()
    assert len(mf.pull("s")) > 0


def test_restore_replays_idle_lru_order():
    """load_state_dict replays the donor's idle-LRU recency order, so
    post-restore eviction releases the donor's OLDEST idle config first
    (advisor round-4 low finding: state-dict iteration order could evict
    a recently used config)."""
    mf = MultiFleet(channels=1, capacity_per_bucket=1,
                    target_chunk_frames=256,
                    max_idle_buckets=3)
    # idle three configs in a known order, then touch the FIRST one so
    # its recency moves to newest: LRU order = [B, C, A]
    keys = [(44100, 48000, 4), (44100, 24000, 4), (44100, 32000, 4)]
    for i, k in enumerate(keys):
        mf.add_stream(f"s{i}", *k)
        mf.end_stream(f"s{i}")
        mf.pull(f"s{i}")
    mf.add_stream("touch", *keys[0])
    mf.end_stream("touch")
    mf.pull("touch")
    assert list(mf._idle) == [keys[1], keys[2], keys[0]]

    import pickle
    clone = MultiFleet(channels=1, capacity_per_bucket=1,
                       target_chunk_frames=256,
                       max_idle_buckets=3)
    clone.load_state_dict(pickle.loads(pickle.dumps(mf.state_dict())))
    assert list(clone._idle) == [keys[1], keys[2], keys[0]]
    # one more idle bucket evicts the donor's oldest (keys[1]), not an
    # arbitrary recently-used key
    clone.add_stream("new", 44100, 16000, 4)
    clone.end_stream("new")
    clone.pull("new")
    assert keys[1] not in clone._buckets
    assert keys[2] in clone._buckets and keys[0] in clone._buckets
