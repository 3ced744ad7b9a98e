"""Double-float FFT: thin wrappers over the generic core (:mod:`.fft_core`).

Kept as a stable public module: the high-precision convolution path
(<= 1 LSB @ 24-bit, BASELINE.md north star) is ``fft_core`` instantiated
with double-float arithmetic. See fft_core's docstring for the
algorithm and its accuracy.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import fft_core
from .df64 import CDF64
from .fft_core import ARITH_DF64


def fft_cdf64(z: CDF64, n: int) -> CDF64:
    """Complex Stockham FFT in double-float (natural order in/out)."""
    return fft_core.fft(z, n, ARITH_DF64)


def ifft_cdf64(z: CDF64, n: int) -> CDF64:
    return fft_core.ifft(z, n, ARITH_DF64)


def rfft_df64(x: jnp.ndarray) -> CDF64:
    """Real float32 [.., n] -> CDF64 spectrum [.., n/2+1]."""
    return fft_core.rfft(x, ARITH_DF64)


def irfft_df64(X: CDF64, n: int) -> jnp.ndarray:
    """CDF64 spectrum [.., n/2+1] -> real float32 [.., n]."""
    return fft_core.irfft(X, n, ARITH_DF64)


def rfft_multiply_irfft(blocks: jnp.ndarray, H: CDF64) -> jnp.ndarray:
    """Fused overlap-save spectral step in double-float."""
    return fft_core.rfft_multiply_irfft(blocks, H, ARITH_DF64)
