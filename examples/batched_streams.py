"""Many lockstep streams in one device launch: BatchedResampler.

The reference scales by one resampler state per stream (Readme.md:20-21);
here S streams x C channels become S*C lanes of a single phase-indexed
matmul per launch, so one compiled XLA program serves the whole
batch.  This demo runs 8 streams, checkpoints the engine mid-stream,
replays the second half on a restored copy, and checks the outputs agree
bit-for-bit.
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

from speex_resampler_tpu import BatchedResampler

S, CHANNELS, IN_RATE, OUT_RATE, QUALITY = 8, 2, 44100, 48000, 7


def main() -> None:
    rng = np.random.default_rng(1)
    eng = BatchedResampler(S, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                           target_chunk_frames=1024)
    print(f"launch quantum: {eng.in_frames_per_launch} in-frames -> "
          f"{eng.out_frames_per_launch} out-frames "
          f"({eng.launch_latency_ms:.1f} ms of audio)")

    first = rng.integers(-30000, 30000, (S, 4000, CHANNELS), dtype=np.int16)
    second = rng.integers(-30000, 30000, (S, 3000, CHANNELS), dtype=np.int16)

    out1 = eng.process(first)
    snap = eng.state_dict()              # checkpoint mid-stream

    out2 = eng.process(second)
    tail = eng.flush()

    # restore the checkpoint into a FRESH engine and replay the second half
    eng2 = BatchedResampler(S, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                            target_chunk_frames=1024)
    eng2.load_state_dict(snap)
    out2b = eng2.process(second)
    tail_b = eng2.flush()
    assert np.array_equal(out2, out2b) and np.array_equal(tail, tail_b), \
        "checkpoint replay must be bit-identical"

    n_in = first.shape[1] + second.shape[1]
    n_out = out1.shape[1] + out2.shape[1] + tail.shape[1]
    in_s, out_s = n_in / IN_RATE, n_out / OUT_RATE
    print(f"{S} streams: in {in_s:.4f}s -> out {out_s:.4f}s each")
    assert abs(in_s - out_s) < 0.01, "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
