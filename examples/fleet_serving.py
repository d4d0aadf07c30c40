"""Fleet serving: ragged per-stream pushes, lockstep device launches.

FleetResampler fronts the batch engine with the native C++ stager
(native/speex_tpu_runtime.cpp): each stream owns a FIFO accepting pushes
at any cadence and any byte alignment; whenever EVERY active stream has a
full launch quantum staged, poll() gathers the time-major slab and runs
one device launch for all of them.  This demo drives 16 streams with
randomized chunk sizes, then drains with the terminal flush().
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

from speex_resampler_tpu.runtime import FleetResampler

S, CHANNELS, IN_RATE, OUT_RATE, QUALITY = 16, 2, 44100, 48000, 7


def main() -> None:
    rng = np.random.default_rng(7)
    fleet = FleetResampler(S, CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                           target_chunk_frames=1024)

    seconds = 0.4
    n_frames = int(IN_RATE * seconds)
    pcm = [rng.integers(-25000, 25000, (n_frames, CHANNELS),
                        dtype=np.int16).tobytes() for _ in range(S)]

    # push ragged byte slices per stream; poll as we go — launches fire
    # whenever the slowest stream completes a quantum
    cursors = [0] * S
    launches = 0
    while any(c < len(pcm[s]) for s, c in enumerate(cursors)):
        for s in range(S):
            if cursors[s] < len(pcm[s]):
                n = int(rng.integers(1, 16384))
                fleet.push_bytes(s, pcm[s][cursors[s]:cursors[s] + n])
                cursors[s] += n
        launches += fleet.poll()
    fleet.flush()                        # end-of-stream drain (terminal)

    out_frames = [len(fleet.pull_bytes(s)) // (CHANNELS * 2)
                  for s in range(S)]
    in_s = n_frames / IN_RATE
    out_s = [n / OUT_RATE for n in out_frames]
    print(f"{S} streams, {launches} lockstep launches; in {in_s:.4f}s -> "
          f"out {min(out_s):.4f}..{max(out_s):.4f}s")
    assert all(abs(in_s - o) < 0.01 for o in out_s), \
        "duration invariant violated"
    print("ok")


if __name__ == "__main__":
    main()
