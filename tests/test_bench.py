"""bench.py's sections at a tiny size on the CPU (control flow only: its
times mean something only on the GPU, where main() insists on running)."""

import importlib.util
import sys

import pytest

from conftest import REPO


@pytest.fixture
def bench(monkeypatch):
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["bench"] = mod
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "N_STREAMS", 2)
    monkeypatch.setattr(mod, "ITERS_SHORT", 1)
    monkeypatch.setattr(mod, "ITERS_LONG", 2)
    monkeypatch.setattr(mod, "REPS", 1)
    return mod


def test_bench_refuses_without_gpu(bench, capsys):
    assert bench.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "'cpu'" in out.err


@pytest.mark.parametrize("fixed,latency", [(False, None), (True, None),
                                           (False, 20.0)])
def test_measure_config_geometry(bench, fixed, latency):
    m = bench.measure_config(*bench.FLAGSHIP, fixed_point=fixed,
                             max_latency_ms=latency, n_slopes=1)
    assert m["kernel"] == "dense"
    assert m["in_frames_per_launch"] == (882 if latency else 9408)
    assert len(m["launch_ms_runs"]) == 1


@pytest.mark.parametrize("section", ["fleet", "fleet_fixed", "multifleet",
                                     "stager", "single_stream"])
def test_bench_sections_run(bench, section):
    if section == "fleet":
        r = bench.fleet_e2e(n_streams=2)
        assert r["launches"] == 5 and not r["degraded"]
        assert r["device_consumer_out_samples_per_sec"] > 0
    elif section == "fleet_fixed":
        r = bench.fleet_e2e(fixed_point=True, n_streams=2)
        assert r["launches"] == 5 and not r["degraded"]
    elif section == "multifleet":
        r = bench.multifleet_e2e(n_streams=8, target_frames=512)
        assert r["buckets"] == 4 and not r["degraded"]
    elif section == "stager":
        assert bench.stager_bench()["gather_lm_samples_per_sec"] > 0
    else:
        r = bench.single_stream_bench(seconds=0.03)
        assert r["out_samples_per_sec"] > 0
