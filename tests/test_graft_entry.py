"""__graft_entry__: the one-device compile check and the lane-sharded dry
run of the production steps on virtual CPU devices."""

import importlib.util
import os

import pytest

from conftest import REPO


@pytest.fixture
def graft(monkeypatch):
    # importing stages XLA_FLAGS for a fresh process; keep this one's
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_step_runs(graft):
    fn, args = graft.entry()
    hist, y = fn(*args)
    assert hist.shape == args[0].shape and y.shape[1] == args[1].shape[1]


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip(graft, n_devices):
    graft.dryrun_multichip(n_devices)
