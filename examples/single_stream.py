"""One stream through the reference-compatible API.

Mirrors the reference's basic usage (Readme.md "Usage", src/index.ts:50):
interleaved s16 PCM bytes in -> resampled s16 PCM bytes out, with the
filter state carried across calls.
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

from speex_resampler_tpu import SpeexResampler

IN_RATE, OUT_RATE, CHANNELS, QUALITY = 44100, 48000, 2, 7


def make_tone(rate: int, seconds: float, channels: int) -> np.ndarray:
    t = np.arange(int(rate * seconds)) / rate
    wave = 0.5 * np.sin(2 * np.pi * 440.0 * t)
    pcm = np.round(wave * 32767).astype(np.int16)
    return np.repeat(pcm[:, None], channels, axis=1)


def main() -> None:
    resampler = SpeexResampler(CHANNELS, IN_RATE, OUT_RATE, QUALITY)
    # optional: swallow the filter's leading delay, like
    # speex_resampler_skip_zeros (resample.c:1200-1206)
    resampler.skip_zeros()

    frames = make_tone(IN_RATE, 0.25, CHANNELS)
    out = bytearray()
    # stream in 20 ms chunks; any chunk size that is a whole number of
    # frames (channels*2 bytes) is legal
    step = int(IN_RATE * 0.020)
    for i in range(0, frames.shape[0], step):
        chunk = frames[i:i + step].tobytes()
        out += resampler.process_chunk(chunk)

    in_s = frames.shape[0] / IN_RATE
    out_s = len(out) / (CHANNELS * 2) / OUT_RATE
    print(f"in  {frames.shape[0]} frames @ {IN_RATE} Hz = {in_s:.4f}s")
    print(f"out {len(out) // (CHANNELS * 2)} frames @ {OUT_RATE} Hz = "
          f"{out_s:.4f}s")
    print(f"input latency  {resampler.get_input_latency()} samples, "
          f"output latency {resampler.get_output_latency()} samples")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
