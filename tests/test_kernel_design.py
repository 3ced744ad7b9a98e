"""Kernel design property tests (SURVEY.md §4.2).

DC gain, symmetry, Smith length rule, spectral inversion, band filters.
"""

import numpy as np
import pytest

from lowcut.ops import kernel_design as kd


def test_kernel_length_defaults_match_reference_reconstruction():
    # Defaults: slope 10 Hz @ 44.1 kHz -> M = 17640 (SURVEY.md §2.2).
    assert kd.kernel_length(10.0 / 44100.0) == 17640
    # Narrow band: 5 Hz @ 96 kHz -> 76800 (BASELINE config 2 regime).
    assert kd.kernel_length(5.0 / 96000.0) == 76800
    # Always even.
    for bw in (80.0 / 44100.0, 0.013, 0.0101):
        assert kd.kernel_length(bw) % 2 == 0


def test_kernel_length_validation():
    with pytest.raises(ValueError):
        kd.kernel_length(0.0)
    with pytest.raises(ValueError):
        kd.kernel_length(0.6)


def test_lowpass_unity_dc_gain_and_symmetry():
    h = kd.lowpass_taps(0.01, 400)
    assert h.dtype == np.float64
    assert np.isclose(np.sum(h), 1.0, atol=1e-14)          # DC gain 1
    np.testing.assert_allclose(h, h[::-1], atol=1e-18)      # type-I symmetric


def test_lowpass_frequency_response():
    fc = 0.05
    m = kd.kernel_length(0.01)
    h = kd.lowpass_taps(fc, m)
    H = np.abs(np.fft.rfft(h, 8192))
    f = np.fft.rfftfreq(8192)
    # passband ~1, stopband ~0 (Blackman: ~-74 dB)
    assert np.all(np.abs(H[f < fc - 0.01] - 1.0) < 1e-3)
    assert np.all(H[f > fc + 0.01] < 10 ** (-70 / 20))


def test_highpass_zero_dc_gain():
    h = kd.highpass_taps(0.01, 400)
    assert abs(np.sum(h)) < 1e-13                           # DC gain 0
    np.testing.assert_allclose(h, h[::-1], atol=1e-18)


def test_highpass_is_spectral_inversion():
    lp = kd.lowpass_taps(0.02, 200)
    hp = kd.highpass_taps(0.02, 200)
    np.testing.assert_allclose(hp, kd.spectral_invert(lp), atol=0)
    # LP + HP = identity (delta at center)
    delta = np.zeros(201)
    delta[100] = 1.0
    np.testing.assert_allclose(lp + hp, delta, atol=1e-18)


def test_spectral_invert_requires_odd_length():
    with pytest.raises(ValueError):
        kd.spectral_invert(np.ones(10))


def test_bandpass_and_bandreject():
    m = kd.kernel_length(0.02)
    bp = kd.bandpass_taps(0.05, 0.15, m)
    br = kd.bandreject_taps(0.05, 0.15, m)
    F = 4096
    f = np.fft.rfftfreq(F)
    Hbp = np.abs(np.fft.rfft(bp, F))
    Hbr = np.abs(np.fft.rfft(br, F))
    inband = (f > 0.07) & (f < 0.13)
    outband = (f < 0.03) | (f > 0.17)
    assert np.all(np.abs(Hbp[inband] - 1.0) < 1e-2)
    assert np.all(Hbp[outband] < 1e-3)
    assert np.all(np.abs(Hbr[inband]) < 1e-2)
    assert np.all(np.abs(Hbr[outband] - 1.0) < 1e-3 + 1e-2)
    with pytest.raises(ValueError):
        kd.bandpass_taps(0.2, 0.1, m)


def test_windowed_sinc_api_parity():
    # WindowedSinc(freq/fs, slope/fs).make_low_cut() as at ProcessFile.cp:48-50
    ws = kd.WindowedSinc(15.0 / 44100.0, 10.0 / 44100.0)
    assert ws.m == 17640 and ws.mo2 == 8820 and ws.num_taps == 17641
    ws.make_low_cut()
    assert abs(np.sum(ws.taps)) < 1e-10


def test_fms_overloads_consistent():
    ws = kd.WindowedSinc(0.05, 0.02)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(ws.num_taps + 50)
    full = ws.fms(x, 10)
    manual = float(np.dot(ws.taps, x[10 : 10 + ws.num_taps]))
    assert np.isclose(full, manual, rtol=1e-15)
    # partial overloads
    assert np.isclose(ws.fms(x, 0, -30), float(np.dot(ws.taps[-30:], x[:30])), rtol=1e-15)
    assert np.isclose(ws.fms(x, 5, 40), float(np.dot(ws.taps[:40], x[5:45])), rtol=1e-15)
