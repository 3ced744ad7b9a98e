"""Correctness oracle: float64 direct convolution, reference edge semantics.

The reference's hot loop (/root/reference/FilterCore.h:20-79) computes, for
each output sample i of one channel x (length N) with kernel h (length M+1,
center Mo2 = M/2):

    out[i] = float32( sum_{k=0}^{M} h[k] * x[i - Mo2 + k] )     (float64 sum)

with x treated as zero outside [0, N). Its three loop phases (prologue /
body / epilogue, FilterCore.h:57-76) are exactly this zero-padded formula —
verified tap-index-by-tap-index in SURVEY.md §2.2 — restricted to where the
kernel partially overlaps the signal.

This module is the golden model for every device engine (SURVEY.md §4.1).
``direct_filter`` is the literal O(N*M) definition; ``fft_filter_f64`` is a
float64 overlap-free FFT evaluation of the same formula (error ~1e-15,
usable as oracle for large N*M where direct is too slow).
"""

from __future__ import annotations

import numpy as np


def direct_filter(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Literal reference semantics: float64 accumulate, cast to float32.

    O(N*M) — use only on small test shapes.
    """
    x64 = np.asarray(x, dtype=np.float64)
    h64 = np.asarray(h, dtype=np.float64)
    m = len(h64) - 1
    if m % 2 != 0:
        raise ValueError("kernel must have odd length (even order M)")
    mo2 = m // 2
    n = len(x64)
    # full convolution with reversed kernel == correlation with h
    c = np.convolve(x64, h64[::-1], mode="full")  # length n + m
    out = c[mo2 : mo2 + n]
    return out.astype(np.float32)


def fft_filter_f64(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Same formula evaluated via float64 FFT (fast oracle for large shapes)."""
    x64 = np.asarray(x, dtype=np.float64)
    h64 = np.asarray(h, dtype=np.float64)
    m = len(h64) - 1
    mo2 = m // 2
    n = len(x64)
    size = 1
    while size < n + m + 1:
        size <<= 1
    c = np.fft.irfft(np.fft.rfft(x64, size) * np.fft.rfft(h64[::-1], size), size)
    return c[mo2 : mo2 + n].astype(np.float32)


def window_filter_f64(x: np.ndarray, h: np.ndarray, start: int,
                      stop: int) -> np.ndarray:
    """``direct_filter(x, h)[start:stop]`` computed from the window
    x[start - Mo2 : stop + Mo2] alone (zero outside [0, N)), by float64
    FFT: the oracle for a window of a signal too long to filter whole."""
    h64 = np.asarray(h, dtype=np.float64)
    m = len(h64) - 1
    mo2 = m // 2
    n = len(x)
    lo, hi = start - mo2, stop + mo2
    seg = np.zeros(hi - lo, np.float64)
    a, b = max(lo, 0), min(hi, n)
    seg[a - lo : b - lo] = x[a:b]
    size = 1
    while size < len(seg) + m:
        size <<= 1
    c = np.fft.irfft(np.fft.rfft(seg, size) * np.fft.rfft(h64[::-1], size),
                     size)
    return c[m : m + stop - start].astype(np.float32)


def direct_filter_loops(x: np.ndarray, sinc, progress=None) -> np.ndarray:
    """Transliteration of the reference's 3-phase loop structure, using a
    :class:`~..ops.kernel_design.WindowedSinc` via its ``fms`` overloads.

    Exists purely to *prove in tests* that the closed-form zero-padded
    convolution above matches the reference's loop phases exactly
    (FilterCore.h:57-76). Never used in production paths.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    mo2 = sinc.mo2
    out = np.empty(n, dtype=np.float32)
    i = 0
    # Prologue: left edge, partial kernel (FilterCore.h:57-61)
    while i < n and i < mo2:
        overlap = i + mo2 + 1
        out[i] = np.float32(sinc.fms(x, 0, -overlap))
        i += 1
    # Body: full overlap (FilterCore.h:64-69)
    safe_limit = min(n, n - mo2)
    while i < safe_limit:
        out[i] = np.float32(sinc.fms(x, i - mo2))
        i += 1
    # Epilogue: right edge, partial kernel (FilterCore.h:72-76)
    while i < n:
        remaining = n - i + mo2
        out[i] = np.float32(sinc.fms(x, i - mo2, remaining))
        i += 1
    return out


def quantization_lsb(bits: int) -> float:
    """One LSB at the given bit depth, in full-scale float units (2^-(bits-1))."""
    return 2.0 ** -(bits - 1)


def max_lsb_error(a: np.ndarray, b: np.ndarray, bits: int = 24) -> float:
    """Max |a-b| expressed in LSBs at the given bit depth (fidelity metric)."""
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                 / quantization_lsb(bits))


def max_scaled_lsb_error(a: np.ndarray, b: np.ndarray, bits: int = 24) -> float:
    """Max |a-b| in LSBs at the given depth, RELATIVE to the output scale.

    The engine's deterministic precision bound (fft_core._ArithDF40) is
    ulp-relative: <= 1 f32 ulp of the output's binade. For output peaks in
    [1, 2) one f32 ulp == one 24-bit LSB and this equals
    :func:`max_lsb_error`; for peaks in [2, 4) the LSB unit doubles, so an
    ulp-exact engine still measures <= 1 here where the absolute metric
    would spuriously read 2. Peaks below full scale do NOT shrink the unit
    (the gate never gets weaker than the absolute 1-LSB promise)."""
    peak = float(np.max(np.abs(np.asarray(b, np.float64))))
    scale = 2.0 ** np.floor(np.log2(peak)) if peak > 1.0 else 1.0
    return max_lsb_error(a, b, bits) / max(1.0, scale)
