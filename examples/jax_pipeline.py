"""Embedding the resampler inside your own jitted JAX pipeline.

The stateful engines own staging and accounting; the functional API
(speex_resampler_tpu.functional) exposes the underlying PURE step so
resampling can be one fused stage of a larger on-device graph — here a
toy feature extractor: resample 44.1 kHz -> 48 kHz, then window energies,
all inside one jax.jit (one device launch per quantum).
"""

import numpy as np

# runnable from a raw checkout: fall back to the repo root if the package
# is not installed
try:
    import speex_resampler_tpu  # noqa: F401
except ImportError:  # pragma: no cover
    import pathlib
    import sys as _sys
    _sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from speex_resampler_tpu.functional import make_stream_fn, resample_array

B = 8  # lanes (streams x channels)


def main() -> None:
    rs = make_stream_fn(44100, 48000, quality=7, target_in_frames=1024)
    print(f"quantum: {rs.in_frames} in -> {rs.out_frames} out frames")

    @jax.jit
    def pipeline(hist, pcm):
        hist, y = rs.step(hist, pcm)              # resample
        f = y.astype(jnp.float32) / 32768.0
        win = f[: (f.shape[0] // 256) * 256].reshape(-1, 256, B)
        energy = jnp.mean(jnp.square(win), axis=1)  # per-window energy
        return hist, y, energy

    rng = np.random.default_rng(2)
    hist = rs.init(B)
    n_out = 0
    for _ in range(4):
        pcm = jnp.asarray(rng.integers(-25000, 25000, (rs.in_frames, B),
                                       dtype=np.int16))
        hist, y, energy = pipeline(hist, pcm)
        n_out += y.shape[0]
    print(f"4 fused launches: {4 * rs.in_frames} in -> {n_out} out frames, "
          f"energy grid {energy.shape}")
    assert abs(n_out / 48000 - 4 * rs.in_frames / 44100) < 0.01

    # one-shot convenience for finite signals (host API)
    tone = np.round(0.5 * 32767 * np.sin(
        2 * np.pi * 440 * np.arange(22050) / 44100)).astype(np.int16)
    out = resample_array(tone, 44100, 48000, quality=7)
    assert abs(len(out) / 48000 - len(tone) / 44100) < 0.01
    print(f"one-shot: {len(tone)} -> {len(out)} samples")
    print("ok")


if __name__ == "__main__":
    main()
