"""Ragged byte streams through SpeexResamplerTransform.

The reference's Node Transform stream re-aligns arbitrarily split byte
chunks to whole frames with a carry buffer (src/index.ts:139-161).  This
demo pushes deliberately misaligned chunks (including 1-byte ones) through
the sync API, then the same stream through the asyncio API, and checks the
two agree byte-for-byte.
"""

import asyncio

import numpy as np

# runnable from a raw checkout: fall back to the repo root if the package
# is not installed
try:
    import speex_resampler_tpu  # noqa: F401
except ImportError:  # pragma: no cover
    import pathlib
    import sys as _sys
    _sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from speex_resampler_tpu import SpeexResamplerTransform

IN_RATE, OUT_RATE, CHANNELS, QUALITY = 24000, 48000, 1, 5


def ragged_chunks(data: bytes, seed: int = 0):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(data):
        n = int(rng.integers(1, 4097))
        yield data[i:i + n]
        i += n


def main() -> None:
    t = np.arange(IN_RATE // 4) / IN_RATE
    pcm = np.round(0.4 * 32767 * np.sin(2 * np.pi * 330 * t)).astype(
        np.int16).tobytes()

    # sync push style: transform() returns whatever is producible now
    tf = SpeexResamplerTransform(CHANNELS, IN_RATE, OUT_RATE, QUALITY)
    out_sync = b"".join(tf.transform(c) for c in ragged_chunks(pcm))
    out_sync += tf.flush()

    # asyncio style, same ragged schedule
    async def run_async() -> bytes:
        tf = SpeexResamplerTransform(CHANNELS, IN_RATE, OUT_RATE, QUALITY)
        parts = [await tf.atransform(c) for c in ragged_chunks(pcm)]
        parts.append(tf.flush())
        return b"".join(parts)

    out_async = asyncio.run(run_async())
    assert out_sync == out_async, "sync and asyncio paths must agree"

    in_s = len(pcm) / (CHANNELS * 2) / IN_RATE
    out_s = len(out_sync) / (CHANNELS * 2) / OUT_RATE
    print(f"in {in_s:.4f}s -> out {out_s:.4f}s across "
          f"{sum(1 for _ in ragged_chunks(pcm))} ragged chunks")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
