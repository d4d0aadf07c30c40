"""chip_smoke.py rehearsed on the CPU at a tiny size.

The script refuses to run anywhere but on a GPU; these tests lift that
check through the ``smoke`` fixture only (never through a flag of the
script) and shrink its sizes, so every phase's control flow, reference
and verdict run here.  Its numbers on the card come from the chip run.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO

TINY = dict(streams=2, family_streams=2, multifleet_streams=2, launches=3,
            single_chunks=10)


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod      # dataclasses resolve through it
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def smoke(monkeypatch, tmp_path):
    from speex_resampler_tpu.utils import gpu_script
    mod = _load()
    monkeypatch.setattr(mod, "EXPECTED_PLATFORM", "cpu")
    monkeypatch.setattr(mod, "SIZE", mod.Size(**TINY))
    # the persistent cache is process-wide; its choice of directory is
    # tested in child processes below
    monkeypatch.setattr(gpu_script, "use_compile_cache",
                        lambda root: tmp_path)
    return mod


def _all_ok(recs):
    assert recs and all(r["ok"] for r in recs), recs


@pytest.mark.parametrize("universe", ["float", "fixed"])
def test_flagship_phase(smoke, universe):
    rec, _ = smoke.run_batched(
        f"flagship {universe}", 2, *smoke.FLAGSHIP,
        fixed=universe == "fixed", launches=3, seed=0, inspect=True)
    _all_ok([rec])
    assert rec["launches"] == 3 and rec["in_frames_per_launch"] == 9408
    step = rec["step"]
    if universe == "fixed":
        assert step["int8_dots"] > 0 and rec["ties"] == 0
    else:
        assert step["f32_dot_precisions"] == ["HIGHEST"] * len(
            step["f32_dot_precisions"])


@pytest.mark.parametrize("family", range(7))
def test_family_phase(smoke, family):
    name, ir, orr, q, fixed, target, lat = smoke.FAMILIES[family]
    rec, _ = smoke.run_batched(name, 2, ir, orr, q, fixed=fixed,
                               launches=3, seed=family, target=target,
                               max_latency_ms=lat, inspect=True)
    _all_ok([rec])
    if "gather" in name:
        assert rec["kernel"] == "gather"
    if lat is not None:
        assert rec["in_frames_per_launch"] <= lat * ir / 1000


@pytest.mark.parametrize("phase", ["phase_fleet", "phase_multifleet",
                                   "phase_single_stream",
                                   "phase_precision"])
def test_serving_and_single_stream_phases(smoke, phase):
    _all_ok(getattr(smoke, phase)(smoke.SIZE, 0))


def test_fleet_phase_uses_native_stager(smoke):
    (rec,) = smoke.phase_fleet(smoke.SIZE, 1)
    assert rec["native_stager"] and rec["launches"] >= 3


def test_four_card_phase_on_virtual_devices(smoke):
    import jax
    recs = smoke.phase_four_cards(smoke.SIZE, 0, jax.devices()[:4])
    _all_ok(recs)
    by = {r["phase"]: r for r in recs}
    assert by["4 cards flagship fixed"]["bitwise_equal_unsharded"]
    assert all(r["device_sets"] == [4, 4] for r in recs
               if "device_sets" in r)


@pytest.mark.parametrize("kind", ["dense", "gather", "single_stream"])
def test_every_float_dot_lowered_at_highest(smoke, kind):
    """Every f32 dot of the dense, gather and single-stream steps keeps
    Precision.HIGHEST (full FP32 on the card, never TF32)."""
    import jax.numpy as jnp
    if kind == "single_stream":
        (rec,) = smoke.phase_precision(smoke.SIZE, 0)
        precisions = rec["step"]["f32_dot_precisions"]
    else:
        from speex_resampler_tpu.parallel.batch import BatchedResampler
        cfg, target = (((44100, 48000, 7), 9408) if kind == "dense"
                       else ((44100, 44101, 1), 44100))
        eng = BatchedResampler(2, 2, *cfg, target_chunk_frames=target)
        assert eng.bspec.kernel == kind
        x = jnp.zeros((eng._step.chunk_rows, eng.B), jnp.int16)
        precisions = smoke.float_dot_precisions(
            eng._step.fn.lower(eng._hist, x, eng._w).as_text())
    assert precisions and set(precisions) == {"HIGHEST"}, precisions


def test_precision_parser_flags_default_dots(smoke):
    text = ("%1 = stablehlo.dot_general %a, %b, contracting_dims = [1] x "
            "[0] : (tensor<4x8xf32>, tensor<8x2xf32>) -> tensor<4x2xf32>\n"
            "%2 = stablehlo.dot_general %a, %b, contracting_dims = [1] x "
            "[0], precision = [HIGHEST, HIGHEST] : (tensor<4x8xf32>, "
            "tensor<8x2xf32>) -> tensor<4x2xf32>\n"
            "%3 = stablehlo.dot_general %c, %d, contracting_dims = [1] x "
            "[0] : (tensor<4x8xi8>, tensor<8x2xi8>) -> tensor<4x2xi32>")
    assert smoke.float_dot_precisions(text) == ["DEFAULT", "HIGHEST"]
    assert smoke.int8_dots(text) == 1


@pytest.mark.parametrize("case", ["fixed_mismatch", "float_two_lsb",
                                  "float_too_many_ties", "shape",
                                  "degraded"])
def test_verdict_rejects(smoke, case):
    want = np.zeros(1000, np.int16)
    got = want.copy()
    kw = {}
    exact = case == "fixed_mismatch"
    if case == "fixed_mismatch":
        got[3] = 1
    elif case == "float_two_lsb":
        got[3] = 2
    elif case == "float_too_many_ties":
        got[:100] = 1
    elif case == "shape":
        got = got[:-1]
    else:
        kw["degraded"] = True
    assert not smoke.verdict("x", got, want, exact=exact, **kw)["ok"]
    got = want.copy()
    got[:5] = 1
    assert smoke.verdict("x", got, want, exact=False)["ok"]


def test_whole_script_rehearsal(smoke, capsys):
    """main() end to end at the tiny size: every phase passes and the
    last stdout line is the contract's JSON object."""
    assert smoke.main(["--seed", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("card: ")
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 8}}
    phases = [json.loads(l[len("phase "):]) for l in lines
              if l.startswith("phase ")]
    assert len(phases) == 2 + 7 + 4 and all(p["ok"] for p in phases)


def test_refuses_without_gpu(capsys):
    """Off the GPU the script exits 2, names the platform it found and
    prints no result line."""
    mod = _load()
    assert mod.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "'cpu'" in out.err


def test_script_refuses_cpu_as_a_process():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode != 0
    assert "'cpu'" in r.stderr and '"ok"' not in r.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the cache is written there and
    nowhere else; unset, it goes to build/jax_cache under the checkout."""
    root = tmp_path / "checkout"
    root.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
               PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache_env")
    code = ("import sys, jax, jax.numpy as jnp\n"
            "from speex_resampler_tpu.utils.gpu_script import "
            "use_compile_cache\n"
            "print(use_compile_cache(sys.argv[1]))\n"
            "jax.jit(lambda a: jnp.sin(a) @ a)(jnp.ones((8, 8))"
            ").block_until_ready()\n")
    r = subprocess.run([sys.executable, "-c", code, str(root)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    expect = (tmp_path / "cache_env" if env_set
              else root / "build" / "jax_cache")
    assert r.stdout.strip() == str(expect)
    assert expect.is_dir() and any(expect.iterdir())
    if env_set:
        assert not (root / "build").exists()
