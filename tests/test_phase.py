"""Property tests for the closed-form phase math and padded weight builder.

The closed form must agree with the reference's sequential recurrence
(resample.c:372-378) for arbitrary ratios, and the padded weight matrix
must place every output's taps where the dense step's patches read them.
"""

import math

import numpy as np
import pytest

from speex_resampler_tpu.ops import filter_design as fd
from speex_resampler_tpu.ops import phase as ph


def _sequential(n_out, ls0, f0, num, den):
    """The reference recurrence, literally."""
    int_advance, frac_advance = num // den, num % den
    ls, f = ls0, f0
    starts, phases = [], []
    for _ in range(n_out):
        starts.append(ls)
        phases.append(f)
        ls += int_advance
        f += frac_advance
        if f >= den:
            f -= den
            ls += 1
    return starts, phases, ls, f


@pytest.mark.parametrize("num,den", [(1, 2), (147, 160), (160, 147),
                                     (147, 80), (1, 1), (320, 147),
                                     (12345, 677), (7, 9973)])
def test_closed_form_matches_recurrence(num, den):
    g = math.gcd(num, den)
    num, den = num // g, den // g
    rng = np.random.default_rng(num * 31 + den)
    for _ in range(5):
        ls0 = int(rng.integers(0, 50))
        f0 = int(rng.integers(0, den))
        n_out = int(rng.integers(1, 500))
        starts, phases, ls_end, f_end = _sequential(n_out, ls0, f0, num, den)
        k = np.arange(n_out)
        t = f0 + k * num
        assert np.array_equal(ls0 + t // den, starts)
        assert np.array_equal(t % den, phases)
        assert ph.advance(n_out, ls0, f0, num, den) == (ls_end, f_end)
        # producible_outputs counts ALL outputs whose window starts within
        # n_new inputs (several outputs can share a start when upsampling)
        n_new = int(starts[-1]) + 1
        more, _, _, _ = _sequential(n_out + 2 * den, ls0, f0, num, den)
        expected = sum(1 for st in more if st < n_new)
        assert ph.producible_outputs(n_new, ls0, f0, num, den) == expected


@pytest.mark.parametrize("num,den,quality", [
    (147, 160, 7), (1, 2, 5), (147, 80, 5), (1, 1, 10), (3, 4, 0),
    (441, 480, 3), (2, 3, 8),
])
def test_padded_weight_invariants(num, den, quality):
    """build_padded_weights: column r of a super-block holds output r's
    taps at rows [o[r], o[r] + filt_len) and zeros elsewhere, for every
    group factor the engine may pick and a nonzero start phase."""
    from speex_resampler_tpu.ops import fir_matmul as fm
    spec = fd.design_filter(num, den, quality)
    N = spec.filt_len
    for group in sorted({1, fm.choose_group(num, den, N)}):
        for f0 in (0, den // 3):
            W = ph.build_padded_weights(spec.phase_table, num, den, f0,
                                        group)
            assert W.shape == (N + group * num, group * den)
            for r in range(group * den):
                t = f0 + r * num
                o, p = t // den - f0 // den, t % den
                col = W[:, r]
                assert np.array_equal(col[o:o + N], spec.phase_table[p])
                assert not col[:o].any() and not col[o + N:].any()


def test_padded_weights_block_periodicity():
    """A super-block of group*den outputs consumes exactly group*num
    inputs and returns to its start phase, so one weight matrix serves
    every block of every launch."""
    from speex_resampler_tpu.ops import fir_matmul as fm
    num, den = 147, 160
    spec = fd.design_filter(num, den, 7)
    group = fm.choose_group(num, den, spec.filt_len)
    R, stride = group * den, group * num
    for k in (0, 3, 17):
        t0, t1 = (k * R) * num, ((k + 1) * R) * num
        assert t1 // den - t0 // den == stride
        assert t0 % den == t1 % den
