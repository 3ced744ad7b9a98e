"""Shared test helpers."""

import jax


def on_cpu() -> bool:
    return jax.default_backend() == "cpu"


def high_tol_lsb24(engine: str = "fft") -> float:
    """Tolerance (in LSB @ 24-bit) for the high-precision path.

    The gate is 1.0 LSB: ``fft`` runs in native float64 on every backend,
    and the double-float engines reach ~0.5 ulp32 (~0.25 LSB24 at full
    scale) plus the oracle's own f32 cast (0.25) where float32 arithmetic
    is strict. XLA:CPU's excess-precision fusion quirk degrades double-float
    to ~1.5 ulp32 (see fft_core.py's accuracy notes), so CPU runs of the
    double-float engines assert a relaxed 2.5 LSB bound; on the card they
    are held to 1.0.
    """
    return 2.5 if engine != "fft" and on_cpu() else 1.0
