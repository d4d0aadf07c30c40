"""The FIXED_POINT (Q15) universe.

The reference is a dual numeric build (arch.h:39-67): the shipped WASM is
the float build, but `-DFIXED_POINT` selects int16 samples with Q15
integer hot loops.  Both universes exist here; the fixed one is BIT-EXACT
vs the fixed-build reference (wrapping int32 sums are order-independent,
so even the GEMM formulation is exact by construction — zero tolerated
mismatches, asserted in tests/test_fixed.py).

This demo resamples the same signal through both universes and shows they
are close but intentionally NOT identical — different numeric contracts.
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

IN_RATE, OUT_RATE, CHANNELS, QUALITY = 24000, 48000, 1, 5


def run(fixed_point: bool, pcm: bytes) -> np.ndarray:
    r = SpeexResampler(CHANNELS, IN_RATE, OUT_RATE, QUALITY,
                       fixed_point=fixed_point)
    out = r.process_chunk(pcm)
    return np.frombuffer(out, dtype=np.int16)


def main() -> None:
    t = np.arange(IN_RATE // 5) / IN_RATE
    pcm = np.round(0.5 * 32767 * np.sin(2 * np.pi * 1000 * t)).astype(
        np.int16).tobytes()

    y_float = run(False, pcm)
    y_fixed = run(True, pcm)

    n = min(len(y_float), len(y_fixed))
    diff = np.abs(y_float[:n].astype(np.int32) - y_fixed[:n])
    print(f"float build: {len(y_float)} samples; "
          f"fixed build: {len(y_fixed)} samples")
    print(f"max |float - fixed| = {diff.max()} LSB "
          f"(different builds, same filter design)")
    # the two universes implement the same filter; outputs track closely
    assert diff.max() < 64, "universes diverged beyond filter tolerance"
    print("ok")


if __name__ == "__main__":
    main()
