"""The pure-functional JAX API (speex_resampler_tpu.functional).

The step must be (a) numerically identical to the stateful engine it
exposes, (b) composable inside a user's outer jax.jit, and (c) correct in
both numeric universes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speex_resampler_tpu.functional import make_stream_fn, resample_array
from speex_resampler_tpu.parallel.batch import BatchedResampler


def _lanes_from_engine(out):
    # engine [S, n, C] -> lane-major [n, S*C]
    S, n, C = out.shape
    return out.transpose(1, 0, 2).reshape(n, S * C)


@pytest.mark.parametrize("fixed", [False, True])
def test_step_matches_engine(fixed):
    S, C = 3, 2
    rs = make_stream_fn(44100, 48000, 7, target_in_frames=600,
                        fixed_point=fixed)
    eng = BatchedResampler(S, C, 44100, 48000, 7,
                           target_chunk_frames=600, fixed_point=fixed)
    assert eng.in_frames_per_launch == rs.in_frames
    rng = np.random.default_rng(5)
    hist = rs.init(S * C)
    for _ in range(3):
        frames = rng.integers(-30000, 30000, (S, rs.in_frames, C),
                              dtype=np.int16)
        x_lanes = jnp.asarray(_lanes_from_engine(frames))
        hist, y = rs.step(hist, x_lanes)
        out = eng.process(frames)
        assert out.shape[1] == rs.out_frames
        np.testing.assert_array_equal(np.asarray(y),
                                      _lanes_from_engine(out))


def test_step_composes_inside_outer_jit():
    rs = make_stream_fn(24000, 48000, 5, target_in_frames=256)
    B = 4
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.integers(-20000, 20000, (rs.in_frames, B),
                                 dtype=np.int16))

    @jax.jit
    def pipeline(hist, pcm):
        hist, y = rs.step(hist, pcm)
        rms = jnp.sqrt(jnp.mean(jnp.square(y.astype(jnp.float32)), axis=0))
        return hist, y, rms

    hist0 = rs.init(B)
    h1, y1, rms = pipeline(hist0, x)
    h2, y2 = rs.step(hist0, x)  # un-fused reference
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    assert rms.shape == (B,) and float(rms.min()) > 0


def test_step_rejects_wrong_frame_count():
    rs = make_stream_fn(24000, 48000, 5, target_in_frames=256)
    with pytest.raises(ValueError):
        rs.step(rs.init(2), jnp.zeros((rs.in_frames + 1, 2), jnp.int16))


def test_latency_getters_match_engine():
    rs = make_stream_fn(44100, 48000, 7, target_in_frames=600)
    eng = BatchedResampler(1, 1, 44100, 48000, 7, target_chunk_frames=600)
    assert rs.input_latency == eng.input_latency()
    assert rs.output_latency == eng.output_latency()


def test_stream_fn_mesh_sharded_matches_unsharded():
    """The functional step under an 8-device virtual mesh must bit-match
    the unsharded step (lane axis is share-nothing; zero collectives)."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax.sharding.Mesh(np.array(devs[:8]), ("streams",))
    B = 16  # 2 lanes per device
    plain = make_stream_fn(44100, 48000, 7, target_in_frames=600)
    sharded = make_stream_fn(44100, 48000, 7, target_in_frames=600, mesh=mesh)
    assert sharded.in_frames == plain.in_frames
    lane = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "streams"))
    rng = np.random.default_rng(13)
    h_np = np.zeros((plain.hist_rows, B), dtype=np.int16)
    hp, hs = jnp.asarray(h_np), jax.device_put(jnp.asarray(h_np), lane)
    for _ in range(2):
        x_np = rng.integers(-30000, 30000, (plain.in_frames, B),
                            dtype=np.int16)
        hp, yp = plain.step(hp, jnp.asarray(x_np))
        hs, ys = sharded.step(hs, jax.device_put(jnp.asarray(x_np), lane))
        assert len(ys.sharding.device_set) == 8, ys.sharding
        np.testing.assert_array_equal(np.asarray(yp), np.asarray(ys))
        np.testing.assert_array_equal(np.asarray(hp), np.asarray(hs))


def test_resample_array_shapes_and_duration():
    rng = np.random.default_rng(3)
    n = 8000
    mono = rng.integers(-25000, 25000, n, dtype=np.int16)
    stereo = rng.integers(-25000, 25000, (n, 2), dtype=np.int16)
    batch = np.stack([stereo, stereo[::-1]])

    y1 = resample_array(mono, 24000, 48000, 5)
    assert y1.ndim == 1
    y2 = resample_array(stereo, 24000, 48000, 5)
    assert y2.shape[1] == 2
    y3 = resample_array(batch, 24000, 48000, 5)
    assert y3.shape[0] == 2 and y3.shape[2] == 2
    # consistency across the accepted shapes
    np.testing.assert_array_equal(y3[0], y2)
    np.testing.assert_array_equal(y2[:, 0],
                                  resample_array(stereo[:, 0], 24000,
                                                 48000, 5))
    # duration invariant (the reference harness bound, src/test.ts:38-40)
    assert abs(len(y1) / 48000 - n / 24000) < 0.01
