"""Test harness configuration.

Tests run hermetically on CPU with 8 virtual devices (multi-chip sharding
tests use them as a virtual mesh); chip_smoke.py and bench.py run on the
GPU.

The golden source of truth is the reference C core compiled natively
(tests/oracle/oracle.c) with the same defines as the shipped WASM build —
the reference repo itself ships no golden outputs (SURVEY.md §4).
"""

import os
import subprocess
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from speex_resampler_tpu.utils.parity import lsb_tie_limit  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")
RESOURCES = REFERENCE / "resources"
ORACLE = REPO / "build" / "oracle"

# the reference integration matrix, src/test.ts:14-22
AUDIO_TESTS = [
    ("24000hz_mono_test.pcm", 24000, 48000, 1, 5),
    ("24000hz_test.pcm", 24000, 24000, 2, 5),
    ("24000hz_test.pcm", 24000, 48000, 2, 10),
    ("44100hz_test.pcm", 44100, 48000, 2, 7),
    ("44100hz_test.pcm", 44100, 48000, 2, 10),
    ("44100hz_test.pcm", 44100, 48000, 2, 1),
    ("44100hz_test.pcm", 44100, 24000, 2, 5),
]


ORACLE_FIXED = REPO / "build" / "oracle_fixed"


def _build_oracle(exe=ORACLE, define="FLOATING_POINT"):
    exe.parent.mkdir(exist_ok=True)
    src = REPO / "tests" / "oracle" / "oracle.c"
    if exe.exists() and exe.stat().st_mtime > src.stat().st_mtime:
        return
    subprocess.run(
        ["gcc", "-O2", f"-D{define}", "-DOUTSIDE_SPEEX",
         f"-I{REFERENCE}/deps/speex", str(src), "-lm", "-o", str(exe)],
        check=True)


@pytest.fixture(scope="session")
def oracle():
    """Path to the compiled reference oracle binary (float build — the
    universe the shipped WASM artifact uses)."""
    _build_oracle()
    return ORACLE


@pytest.fixture(scope="session")
def oracle_fixed():
    """The reference's OTHER numeric universe: -DFIXED_POINT
    (arch.h:39-67), spx_word16_t = int16, Q15 integer hot loops."""
    _build_oracle(ORACLE_FIXED, "FIXED_POINT")
    return ORACLE_FIXED


@pytest.fixture(scope="session")
def fixture_pcm():
    """Load reference PCM fixtures once; returns dict name -> bytes."""
    return {p.name: p.read_bytes() for p in RESOURCES.glob("*.pcm")}


def oracle_tables(oracle_bin, channels, in_rate, out_rate, quality,
                  dtype=np.float32):
    """dtype = np.float32 for the float oracle, np.int16 for the fixed one
    (spx_word16_t of the respective build)."""
    out = subprocess.run(
        [str(oracle_bin), "tables", str(channels), str(in_rate),
         str(out_rate), str(quality)], capture_output=True,
        check=True).stdout
    nl = out.index(b"\n")
    hdr = out[:nl].decode().split()
    meta = dict(zip(["num", "den", "filt_len", "oversample", "use_direct",
                     "table_len", "int_advance", "frac_advance"],
                    map(int, hdr[:8])))
    meta["cutoff"] = float(hdr[8])
    meta["in_latency"] = int(hdr[9])
    meta["out_latency"] = int(hdr[10])
    table = np.frombuffer(out[nl + 1:], dtype=dtype)
    return meta, table


def oracle_process(oracle_bin, tmp_path, pcm_bytes, channels, in_rate,
                   out_rate, quality, chunk_frames=0, skip_zeros=False):
    """Run the oracle's JS-wrapper-equivalent process loop; returns int16."""
    inp = tmp_path / "in.pcm"
    outp = tmp_path / "out.pcm"
    inp.write_bytes(pcm_bytes)
    cmd = [str(oracle_bin), "process", str(channels), str(in_rate),
           str(out_rate), str(quality), str(chunk_frames), str(inp),
           str(outp)]
    if skip_zeros:
        cmd.append("1")
    subprocess.run(cmd, check=True)
    return np.fromfile(outp, dtype=np.int16)


def assert_lsb_close(ours: np.ndarray, golden: np.ndarray,
                     max_mismatch_rate: float = 5e-3):
    """Assert the BASELINE acceptance bound: max |err| <= 1 LSB, and only a
    small fraction of samples differing at all (rounding-boundary ties).

    The rate bound is Poisson-aware: the true per-sample tie probability of
    the f32-reassociated kernels measures 1e-3..4e-3 across filter lengths
    128..5776 (flat in filt_len), so on short outputs the OBSERVED rate
    fluctuates well above 5e-3 without any systematic divergence — a 421-
    output draw with 4 ties is a p≈16% Poisson event at p_tie=5e-3.  Allow
    mean + 4 sigma + 2, which keeps the false-alarm probability per check
    around 3e-5 while still catching real divergence (which shows up as
    rates 10x the bound or max|err| > 1)."""
    assert ours.shape == golden.shape, (ours.shape, golden.shape)
    if ours.size == 0:
        return
    d = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    assert d.max() <= 1, f"max|err|={d.max()} exceeds 1 LSB"
    n = d.size
    ties = int((d > 0).sum())
    limit = lsb_tie_limit(n, max_mismatch_rate)
    assert ties <= limit, (
        f"{ties} ties over {n} samples exceeds Poisson bound "
        f"{limit:.1f} at p={max_mismatch_rate:g}")
