"""speex_resampler_tpu — batched arbitrary-ratio audio resampler on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
geekuillaume/node-speex-resampler (the Speex/speexdsp resampler behind a
WASM boundary): interleaved s16 PCM in, Kaiser-windowed-sinc polyphase FIR
resampling at an arbitrary rational ratio, quality presets 0-10, streaming
state carried across chunks — matching the reference within 1 LSB.

Instead of translating the C state machine, the hot path exploits the
closed form of the phase recurrence to turn each launch into a single
phase-indexed strided matmul on the device, with streams x channels batched
across the device (see ops/fir_matmul.py and parallel/).
"""

from .api import SpeexResampler, SpeexResamplerTransform
from .utils.errors import (ResamplerError, ResamplerErrorCode, strerror,
                           QUALITY_MAX, QUALITY_MIN, QUALITY_DEFAULT,
                           QUALITY_VOIP, QUALITY_DESKTOP)
from .core.resampler import ResamplerCore
from .parallel.batch import BatchedResampler
from .functional import make_stream_fn, resample_array

__version__ = "0.1.0"

__all__ = [
    "SpeexResampler", "SpeexResamplerTransform", "ResamplerCore",
    "BatchedResampler", "make_stream_fn", "resample_array",
    "ResamplerError", "ResamplerErrorCode", "strerror",
    "QUALITY_MAX", "QUALITY_MIN", "QUALITY_DEFAULT", "QUALITY_VOIP",
    "QUALITY_DESKTOP", "__version__",
]
