"""Native (C++) single-stream FIR twins vs the NumPy semantics references.

ops/fir_exact.py and ops/fir_fixed.py remain the order-faithful semantics
references (themselves differentially pinned against the compiled oracle in
test_exact_direct.py / test_fixed.py); runtime/native.py's
srt_fir_{f32,q15}_{direct,interp} are their compiled twins serving
ResamplerCore's host route at reference-C speed (resample.c:331-559 is the
reference's own hot-loop block).  These tests force the NumPy fallback and
assert the native outputs are bit-identical, across:

  - direct and interpolated paths, float and fixed universes;
  - single (f32 serial) and double (4x f64) float accumulator variants;
  - the phase-grouped output-vectorized float direct path (n_out >= 2*den)
    AND its scalar tail;
  - lazy huge-den specs (gathered rows, identity phases);
  - the uint32 wrap regime (den >= 65537), where the float interp native
    path must REFUSE (NumPy defines the out-of-table gather).
"""

import numpy as np
import pytest

import speex_resampler_tpu.ops.fir_exact as fe
import speex_resampler_tpu.ops.fir_fixed as ff
from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.ops.filter_design import compute_gcd
from speex_resampler_tpu.runtime import native as rt

pytestmark = pytest.mark.skipif(rt.load_runtime() is None,
                                reason="native runtime unavailable")


def _spec_for(in_rate, out_rate, q, fixed):
    g = compute_gcd(in_rate, out_rate)
    return fd.design_filter(in_rate // g, out_rate // g, q,
                            fixed_point=fixed)


def _numpy_twin(monkeypatch, fixed):
    """Run the module with the native hook disabled (pure NumPy)."""
    if fixed:
        monkeypatch.setattr(ff, "_native_fixed", lambda *a, **k: None)
    else:
        monkeypatch.setattr(fe, "_native_exact", lambda *a, **k: None)


CONFIGS = [
    # (in_rate, out_rate, q) — chosen to hit every native code path:
    (8000, 48000, 3),     # direct, den=6, grouped path (n_out >= 2*den)
    (8000, 48000, 10),    # direct + double (q>8 f64 accumulators)
    (48000, 16000, 9),    # direct + double, downsample
    (44100, 48000, 5),    # interp single (den=160)
    (48000, 44100, 10),   # interp double, downsample
    (96000, 11025, 0),    # oversample-halved interp, q0
    (12345, 54321, 6),    # odd ratio, interp
    (44100, 44101, 7),    # den=44101 lazy-table regime
]


@pytest.mark.parametrize("in_rate,out_rate,q", CONFIGS)
@pytest.mark.parametrize("fixed", [False, True])
def test_native_matches_numpy(monkeypatch, in_rate, out_rate, q, fixed):
    spec = _spec_for(in_rate, out_rate, q, fixed)
    rng = np.random.default_rng(q * 7 + fixed)
    B, T = 2, 8192
    X = rng.integers(-32768, 32768,
                     (B, T)).astype(np.int16 if fixed else np.float32)
    n_out = max(4, min(((T - spec.filt_len) * spec.den) // spec.num // 2,
                       3000))
    hits = []
    if fixed:
        orig = ff._native_fixed
        monkeypatch.setattr(ff, "_native_fixed",
                            lambda *a, **k: (hits.append(1),
                                             orig(*a, **k))[1])
        y_nat = ff.resample_fixed(X, 0, 0, n_out, spec)
        _numpy_twin(monkeypatch, fixed)
        y_np = ff.resample_fixed(X, 0, 0, n_out, spec)
    else:
        orig = fe._native_exact
        monkeypatch.setattr(fe, "_native_exact",
                            lambda *a, **k: (hits.append(1),
                                             orig(*a, **k))[1])
        y_nat = fe.resample_exact_state(X, 0, 0, n_out, spec)
        _numpy_twin(monkeypatch, fixed)
        y_np = fe.resample_exact_state(X, 0, 0, n_out, spec)
    assert hits, "native path was not exercised"
    assert np.array_equal(y_nat, y_np)


@pytest.mark.parametrize("fixed", [False, True])
def test_native_nonzero_phase_offsets(monkeypatch, fixed):
    """Mid-stream launches (ls0 > 0, f0 > 0) — the grouped float path must
    respect a phase origin that doesn't start the group cycle at zero."""
    spec = _spec_for(8000, 48000, 4, fixed)
    rng = np.random.default_rng(11)
    X = rng.integers(-32768, 32768,
                     (3, 4096)).astype(np.int16 if fixed else np.float32)
    for ls0, f0 in [(1, 3), (17, spec.den - 1), (64, 1)]:
        n_out = ((4096 - ls0 - spec.filt_len) * spec.den - f0) // spec.num
        n_out = min(n_out, 1500)
        if fixed:
            y_nat = ff.resample_fixed(X, ls0, f0, n_out, spec)
            _numpy_twin(monkeypatch, fixed)
            y_np = ff.resample_fixed(X, ls0, f0, n_out, spec)
            monkeypatch.undo()
        else:
            y_nat = fe.resample_exact_state(X, ls0, f0, n_out, spec)
            _numpy_twin(monkeypatch, fixed)
            y_np = fe.resample_exact_state(X, ls0, f0, n_out, spec)
            monkeypatch.undo()
        assert np.array_equal(y_nat, y_np)


def test_native_grouped_tail(monkeypatch):
    """n_out not a multiple of 16*den exercises the grouped path's scalar
    tail; n_out just below 2*den exercises the ungrouped 4-wide path."""
    spec = _spec_for(8000, 48000, 5, False)  # den=6, direct
    rng = np.random.default_rng(3)
    X = rng.integers(-32768, 32768, (1, 8192)).astype(np.float32)
    for n_out in (2 * spec.den - 1, 2 * spec.den, 16 * spec.den + 5, 997):
        y_nat = fe.resample_exact_state(X, 0, 0, n_out, spec)
        _numpy_twin(monkeypatch, False)
        y_np = fe.resample_exact_state(X, 0, 0, n_out, spec)
        monkeypatch.undo()
        assert np.array_equal(y_nat, y_np), n_out


def test_float_interp_wrap_regime_refuses_native():
    """den >= 65537: phase*oversample wraps uint32 and tap indices can
    leave the table (the NumPy path defines that gather) — the native hook
    must return None so the semantics reference serves the call."""
    spec = fd.design_filter(65537, 65539 * 3, 5)
    assert not spec.use_direct and spec.den >= 65537
    rng = np.random.default_rng(5)
    X = rng.integers(-32768, 32768, (1, 4096)).astype(np.float32)
    n_out = 64
    k = np.arange(n_out, dtype=np.int64)
    t = k * spec.num
    starts = t // spec.den
    phases = t % spec.den
    # craft phases deep enough that offset > oversample + 2 appears
    phases = (phases + spec.den - 1 - int(phases.max())) % spec.den
    off = ((phases * spec.oversample) & 0xFFFFFFFF) // spec.den
    if int(off.max()) > spec.oversample + 2:
        assert fe._native_exact(X, starts, phases, spec, False) is None


def test_engine_routing():
    """ResamplerCore engine knob: auto = host at <= HOST_AUTO_MAX_CHANNELS,
    device above; host outputs are bit-identical to exact=True; device is
    reachable explicitly at 1 channel."""
    from speex_resampler_tpu.core.resampler import (ResamplerCore,
                                                    HOST_AUTO_MAX_CHANNELS)
    from speex_resampler_tpu.utils.errors import ResamplerError

    assert ResamplerCore(1, 147, 160, 44100, 48000, 5)._host_route
    assert ResamplerCore(HOST_AUTO_MAX_CHANNELS, 147, 160, 44100, 48000,
                         5)._host_route
    assert not ResamplerCore(HOST_AUTO_MAX_CHANNELS + 1, 147, 160, 44100,
                             48000, 5)._host_route
    assert not ResamplerCore(1, 147, 160, 44100, 48000, 5,
                             engine="device")._host_route
    assert ResamplerCore(64, 147, 160, 44100, 48000, 5,
                         engine="host")._host_route
    with pytest.raises(ResamplerError):
        ResamplerCore(1, 1, 1, 44100, 48000, 5, exact=True, engine="device")
    with pytest.raises(ResamplerError):
        ResamplerCore(1, 1, 1, 44100, 48000, 5, engine="bogus")

    rng = np.random.default_rng(9)
    x = rng.integers(-32768, 32768, (2048, 2)).astype(np.int16)
    outs = {}
    for eng in ("auto", "host", "device"):
        core = ResamplerCore(2, 147, 160, 44100, 48000, 5, engine=eng)
        outs[eng] = core.process_interleaved(x, 4096)
    exact_core = ResamplerCore(2, 147, 160, 44100, 48000, 5, exact=True)
    y_exact = exact_core.process_interleaved(x, 4096)
    assert np.array_equal(outs["auto"], y_exact)
    assert np.array_equal(outs["host"], y_exact)
    assert outs["device"].shape == y_exact.shape
    assert np.max(np.abs(outs["device"].astype(np.int32)
                         - y_exact.astype(np.int32))) <= 1
