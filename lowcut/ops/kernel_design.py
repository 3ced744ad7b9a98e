"""FIR kernel design: Blackman windowed-sinc, float64, host-side.

Reimplements the capability of the reference's c_lib ``WindowedSinc<float64_t>``
(interface reconstructed in SURVEY.md §2.2 from /root/reference/ProcessFile.cp:48-50
and FilterCore.h:29,59,67,74; algorithm per /root/reference/README.md:50,60-62:
windowed-sinc with Blackman window from Smith, *The Scientist and Engineer's
Guide to DSP*, 2nd ed., ch. 16).

Design is deliberately host-side float64 NumPy: the kernel is computed once per (sample_rate, cutoff, slope) and is tiny work next
to the convolution (SURVEY.md §3.4). For the high-precision device path, taps
and their frequency response are additionally provided as double-float
(hi + lo float32) splits — see :mod:`.df64`.

All filters here are linear-phase type-I FIR: odd length M+1, symmetric about
the center tap M/2 ("Mo2", FilterCore.h:29).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def kernel_length(bw_norm: float) -> int:
    """Kernel order M from the normalized transition bandwidth.

    Smith's rule (ch. 16): M ~= 4 / BW, rounded up to the next even integer
    so the kernel has a true center tap. Defaults (slope 10 Hz @ 44.1 kHz)
    give M = 17640, i.e. 17641 taps — matching SURVEY.md §2.2's
    reconstruction of the reference's sizes.
    """
    if not (0.0 < bw_norm < 0.5):
        raise ValueError(f"normalized transition band must be in (0, 0.5), got {bw_norm}")
    m = int(np.ceil(4.0 / bw_norm))
    return m + (m & 1)


def blackman_window(m: int) -> np.ndarray:
    """Blackman window of length M+1 (float64)."""
    i = np.arange(m + 1, dtype=np.float64)
    return 0.42 - 0.5 * np.cos(2.0 * np.pi * i / m) + 0.08 * np.cos(4.0 * np.pi * i / m)


def lowpass_taps(fc_norm: float, m: int) -> np.ndarray:
    """Blackman windowed-sinc low-pass, M+1 taps, unity DC gain, float64.

    h[i] = sinc-term(2*pi*fc*(i - M/2)) * blackman(i), then normalized so
    sum(h) == 1 (unity gain at DC).
    """
    if not (0.0 < fc_norm < 0.5):
        raise ValueError(f"normalized cutoff must be in (0, 0.5), got {fc_norm}")
    i = np.arange(m + 1, dtype=np.float64)
    x = i - m / 2.0
    h = np.where(x == 0.0, 2.0 * np.pi * fc_norm, np.sin(2.0 * np.pi * fc_norm * x) / np.where(x == 0.0, 1.0, x))
    h = h * blackman_window(m)
    return h / np.sum(h)


def spectral_invert(h: np.ndarray) -> np.ndarray:
    """Low-pass -> high-pass by spectral inversion (Smith ch. 16).

    Negate all taps and add 1 at the center. Requires odd length (type-I).
    This is the reference's ``makeLowCut()`` (ProcessFile.cp:50).
    """
    if len(h) % 2 != 1:
        raise ValueError("spectral inversion needs an odd-length (type-I) kernel")
    out = -np.asarray(h, dtype=np.float64)
    out[len(h) // 2] += 1.0
    return out


def highpass_taps(fc_norm: float, m: int) -> np.ndarray:
    """Blackman windowed-sinc high-pass ("low cut"), M+1 taps, float64."""
    return spectral_invert(lowpass_taps(fc_norm, m))


def bandpass_taps(f_lo_norm: float, f_hi_norm: float, m: int) -> np.ndarray:
    """Band-pass: high-pass at f_lo convolved conceptually = LP(hi) - LP(lo)."""
    if not f_lo_norm < f_hi_norm:
        raise ValueError("band edges must satisfy f_lo < f_hi")
    return lowpass_taps(f_hi_norm, m) - lowpass_taps(f_lo_norm, m)


def bandreject_taps(f_lo_norm: float, f_hi_norm: float, m: int) -> np.ndarray:
    """Band-reject (notch): spectral inversion of the band-pass."""
    return spectral_invert(bandpass_taps(f_lo_norm, f_hi_norm, m))


@dataclasses.dataclass
class WindowedSinc:
    """API-parity mirror of the reference's ``WindowedSinc<float64_t>``.

    ``WindowedSinc(freq/fs, slope/fs)`` then ``make_low_cut()``
    (ProcessFile.cp:48-50). ``mo2`` is the reference's ``getMo2()``
    half-length (FilterCore.h:29). ``taps`` is the full odd-length kernel.
    """

    fc_norm: float
    bw_norm: float

    def __post_init__(self):
        self.m = kernel_length(self.bw_norm)
        self.taps = lowpass_taps(self.fc_norm, self.m)

    @property
    def mo2(self) -> int:
        return self.m // 2

    @property
    def num_taps(self) -> int:
        return self.m + 1

    def make_low_cut(self) -> "WindowedSinc":
        self.taps = spectral_invert(lowpass_taps(self.fc_norm, self.m))
        return self

    def fms(self, x: np.ndarray, start: int, count: int | None = None) -> float:
        """float64 dot product of (part of) the kernel against samples.

        Mirrors the reference's three fms() overloads (FilterCore.h:59,67,74):
        - count None: full kernel against x[start : start+M+1]
        - count < 0:  last |count| taps against x[start : start+|count|]
        - count > 0:  first count taps against x[start : start+count]
        """
        x = np.asarray(x, dtype=np.float64)
        if count is None:
            seg = x[start : start + self.num_taps]
            return float(np.dot(self.taps, seg))
        if count < 0:
            n = -count
            return float(np.dot(self.taps[self.num_taps - n :], x[start : start + n]))
        return float(np.dot(self.taps[:count], x[start : start + count]))
