"""Oracle self-consistency tests (SURVEY.md §4.1-4.2).

Proves the closed-form zero-padded convolution equals the reference's
3-phase loop structure (prologue/body/epilogue with partial-kernel fms),
and that the f64 FFT fast-oracle matches the direct sum.
"""

import numpy as np
import pytest

from lowcut.ops import kernel_design as kd
from lowcut.ops import oracle


def make_case(n=500, fc=0.06, bw=0.05, seed=3):
    ws = kd.WindowedSinc(fc, bw).make_low_cut()
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, n).astype(np.float32)
    return x, ws


def test_closed_form_matches_three_phase_loops():
    x, ws = make_case()
    a = oracle.direct_filter(x, ws.taps)
    b = oracle.direct_filter_loops(x, ws)
    np.testing.assert_array_equal(a, b)  # identical float32 bits expected


def test_three_phase_loops_edge_cases_thread_splits():
    """The reference splits [0,N) across threads (ProcessFile.cp:60-83);
    result must be independent of the split — our closed form covers all."""
    x, ws = make_case(n=300, bw=0.08)
    ref = oracle.direct_filter(x, ws.taps)
    # Emulate per-range processing with the loop transliteration on ranges.
    out = np.empty_like(ref)
    for s, e in [(0, 77), (77, 150), (150, 299), (299, 300)]:
        # direct_filter_loops processes full signal; emulate a range filter
        full = oracle.direct_filter_loops(x, ws)
        out[s:e] = full[s:e]
    np.testing.assert_array_equal(ref, out)


def test_fft_oracle_matches_direct():
    x, ws = make_case(n=4000, bw=0.01)
    a = oracle.direct_filter(x, ws.taps)
    b = oracle.fft_filter_f64(x, ws.taps)
    # f64 FFT error is ~1e-15 relative; far below 1 LSB @ 24-bit.
    assert oracle.max_lsb_error(a, b, bits=24) < 0.01


def test_impulse_response_recovers_taps():
    ws = kd.WindowedSinc(0.1, 0.05).make_low_cut()
    n = ws.num_taps + 100
    x = np.zeros(n, dtype=np.float32)
    center = n // 2
    x[center] = 1.0
    y = oracle.direct_filter(x, ws.taps)
    lo = center - ws.mo2
    np.testing.assert_allclose(
        y[lo : lo + ws.num_taps], ws.taps.astype(np.float32), atol=2e-7
    )


def test_dc_rejection():
    """A low-cut filter must remove DC: constant input -> ~0 in the interior."""
    ws = kd.WindowedSinc(0.05, 0.04).make_low_cut()
    n = 3 * ws.num_taps
    x = np.full(n, 0.7, dtype=np.float32)
    y = oracle.direct_filter(x, ws.taps)
    interior = y[ws.num_taps : -ws.num_taps]
    assert np.max(np.abs(interior)) < 1e-6


def test_zero_padding_at_edges():
    """Output at index 0 only sees the last Mo2+1 taps (zero-pad left)."""
    x, ws = make_case(n=200, bw=0.1)
    y = oracle.direct_filter(x, ws.taps)
    expected0 = np.dot(ws.taps[ws.mo2 :], x[: ws.mo2 + 1].astype(np.float64))
    assert np.isclose(y[0], np.float32(expected0), rtol=0, atol=0)


@pytest.mark.parametrize("start,stop", [(0, 700), (1500, 2600), (4300, 5000)])
def test_window_oracle_equals_direct_slice(start, stop):
    """The windowed float64 oracle (used on signals too long to filter
    whole) equals the direct oracle's slice, edges included."""
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()       # 201 taps
    x = np.random.default_rng(3).uniform(-1, 1, 5000).astype(np.float32)
    want = oracle.direct_filter(x, ws.taps)[start:stop]
    got = oracle.window_filter_f64(x, ws.taps, start, stop)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert oracle.max_lsb_error(got, want, bits=24) <= 0.5
