"""Double-float ("df64") arithmetic: ~49-bit mantissa from float32 pairs.

The reference does its kernel math in float64 (reference FilterCore.h:22,
README.md:10-11). The default ``fft`` engine meets the <=1 LSB @ 24-bit
fidelity target (BASELINE.md) in native float64; the framework's own FFT
engines (``fourstep``, ``pease``, ``stockham``) meet it on float32
arithmetic by running their FFTs in double-float:
each number is an unevaluated sum hi + lo of two float32s (Dekker 1971 /
Knuth TAOCP error-free transformations).

All operations are elementwise jnp ops on (hi, lo) array pairs, fusable by
XLA. Correctness depends on strict IEEE float32 add/mul: no fast-math
reassociation, and no contraction of a multiply and an add into one FMA,
which a GPU compiler may do. tests/test_df64.py asserts the error-free
properties numerically on the CPU, and chip_smoke.py gates each engine
against the float64 oracle on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class DF64(NamedTuple):
    """Unevaluated sum hi + lo, |lo| <= ulp(hi)/2. A JAX pytree."""

    hi: jnp.ndarray
    lo: jnp.ndarray


# 2^12 + 1: Dekker split constant for float32 (24-bit mantissa -> 12+12).
_SPLIT = np.float32(4097.0)


def _two_sum(a, b):
    """Error-free a + b: returns (s, err) with s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b|."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """Error-free a * b via Dekker splitting (no FMA dependency)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ------------------------------------------------------------- constructors

def from_f32(x) -> DF64:
    x = jnp.asarray(x, jnp.float32)
    return DF64(x, jnp.zeros_like(x))


def df64_split_np(x64: np.ndarray) -> DF64:
    """Host-side split of a float64 array into an exact (hi, lo) f32 pair,
    kept as NumPy arrays (safe to cache across jit traces — they embed as
    constants; device arrays created inside a trace would leak tracers)."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return DF64(hi, lo)


def df64_split_array(x64: np.ndarray) -> DF64:
    """Like :func:`df64_split_np` but as device arrays (for jit arguments)."""
    hi, lo = df64_split_np(x64)
    return DF64(jnp.asarray(hi), jnp.asarray(lo))


def to_f64(x: DF64) -> np.ndarray:
    return np.asarray(x.hi, np.float64) + np.asarray(x.lo, np.float64)


def to_f32(x: DF64) -> jnp.ndarray:
    return x.hi + x.lo


# ---------------------------------------------------------------- real ops

def add(x: DF64, y: DF64) -> DF64:
    s, e = _two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    return DF64(*_quick_two_sum(s, e))


def sub(x: DF64, y: DF64) -> DF64:
    return add(x, neg(y))


def neg(x: DF64) -> DF64:
    return DF64(-x.hi, -x.lo)


def mul(x: DF64, y: DF64) -> DF64:
    p, e = _two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF64(*_quick_two_sum(p, e))


def mul_f32(x: DF64, c) -> DF64:
    """Multiply by a plain float32 (exact two_prod on the hi part)."""
    p, e = _two_prod(x.hi, c)
    e = e + x.lo * c
    return DF64(*_quick_two_sum(p, e))


def mul_pow2(x: DF64, c: float) -> DF64:
    """Multiply by an exact power of two (error-free, no renormalization)."""
    c = jnp.float32(c)
    return DF64(x.hi * c, x.lo * c)


def mul_dconst(x: DF64, c_hi: float, c_lo: float) -> DF64:
    """Multiply by a double-float CONSTANT c = c_hi + c_lo (e.g. 1/sqrt(2)).

    Same accuracy as :func:`mul` (drops only the lo*lo term); cheaper
    because the constant's Dekker split folds at compile time.
    """
    c_hi = jnp.float32(c_hi)
    p, e = _two_prod(x.hi, c_hi)
    e = e + (x.hi * jnp.float32(c_lo) + x.lo * c_hi)
    return DF64(*_quick_two_sum(p, e))


# ------------------------------------------------------------- complex ops

class CDF64(NamedTuple):
    """Complex double-float: re + i*im, each a DF64. A JAX pytree."""

    re: DF64
    im: DF64


def cfrom_f32(re, im) -> CDF64:
    return CDF64(from_f32(re), from_f32(im))


def csplit_np(z64: np.ndarray) -> CDF64:
    z64 = np.asarray(z64, np.complex128)
    return CDF64(df64_split_np(z64.real), df64_split_np(z64.imag))


def csplit_array(z64: np.ndarray) -> CDF64:
    z64 = np.asarray(z64, np.complex128)
    return CDF64(df64_split_array(z64.real), df64_split_array(z64.imag))


def cadd(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(add(x.re, y.re), add(x.im, y.im))


def csub(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(sub(x.re, y.re), sub(x.im, y.im))


def cmul(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(
        sub(mul(x.re, y.re), mul(x.im, y.im)),
        add(mul(x.re, y.im), mul(x.im, y.re)),
    )


def cconj(x: CDF64) -> CDF64:
    return CDF64(x.re, neg(x.im))


def cneg_im(x: CDF64) -> CDF64:
    """Multiply by -i: (re, im) -> (im, -re)."""
    return CDF64(x.im, neg(x.re))


def cmul_pow2(x: CDF64, c: float) -> CDF64:
    return CDF64(mul_pow2(x.re, c), mul_pow2(x.im, c))


# --------------------------------------------------- relaxed (unnormalized)
#
# The FFT engine needs ~27 good bits end to end (1 LSB @ 24-bit output,
# BASELINE.md), while strict double-float carries ~49. The relaxed ops skip
# the final quick_two_sum renormalization: results are unevaluated sums
# (hi, lo) with |lo| growing to ~k*ulp(hi) after k chained ops instead of
# ulp(hi)/2. Error analysis: two_sum/two_prod stay error-free on the hi
# parts; the only dropped term is lo*lo (~beta^2 * 2^-48 relative, beta ~
# stage count ~20), and lo-channel rounding is ~beta * 2^-48 per op — both
# orders of magnitude below the 2^-26 requirement, at ~25% fewer flops
# (add 11 -> 8, mul 20 -> 17 f32 ops).

def add_relaxed(x: DF64, y: DF64) -> DF64:
    s, e = _two_sum(x.hi, y.hi)
    return DF64(s, e + (x.lo + y.lo))


def mul_relaxed(x: DF64, y: DF64) -> DF64:
    p, e = _two_prod(x.hi, y.hi)
    return DF64(p, e + (x.hi * y.lo + x.lo * y.hi))


def mul_dconst_relaxed(x: DF64, c_hi: float, c_lo: float) -> DF64:
    c_hi = jnp.float32(c_hi)
    p, e = _two_prod(x.hi, c_hi)
    return DF64(p, e + (x.hi * jnp.float32(c_lo) + x.lo * c_hi))


def cadd_relaxed(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(add_relaxed(x.re, y.re), add_relaxed(x.im, y.im))


# ----------------------------------------------- presplit constant multiply
#
# Multiplying by a CONSTANT table (FFT twiddles, the kernel spectrum) does
# not need the full symmetric mul: the constant's Dekker split is computed
# once on HOST and stored as two extra planes (DF64Const.hh/hl), and the
# value operand's split is computed once and SHARED across the four real
# muls of a complex multiply. Where tables are loaded at run time (not
# XLA-foldable embedded constants) this cuts a relaxed complex
# constant-multiply from ~96 to ~70 f32 flops. Accuracy is
# the same as mul_relaxed (identical error-free hi-part product; the same
# lo*lo term dropped).

class DF64Const(NamedTuple):
    """A double-float constant with its hi part pre-Dekker-split
    (hh + hl == hi exactly). A JAX pytree."""

    hi: jnp.ndarray
    hh: jnp.ndarray
    hl: jnp.ndarray
    lo: jnp.ndarray


class CDF64Const(NamedTuple):
    re: DF64Const
    im: DF64Const


def const_split_np(x64: np.ndarray) -> DF64Const:
    """Host-side exact split of float64 into (hi, hh, hl, lo) NumPy planes."""
    hi, lo = df64_split_np(x64)
    t = _SPLIT * hi
    hh = (t - (t - hi)).astype(np.float32)
    return DF64Const(hi, hh, hi - hh, lo)


def cconst_split_np(z64: np.ndarray) -> CDF64Const:
    z64 = np.asarray(z64, np.complex128)
    return CDF64Const(const_split_np(z64.real), const_split_np(z64.imag))


def conj_const(c: CDF64Const) -> CDF64Const:
    return CDF64Const(c.re, DF64Const(-c.im.hi, -c.im.hh, -c.im.hl, -c.im.lo))


def _mul_const_split(xhi, xlo, xh, xl, c: DF64Const) -> DF64:
    """Relaxed x * c given x's shared split (xh + xl == xhi).

    Keeps ALL four Dekker partial products (xl*c.hl is ~2^-24 relative —
    required for the error-free hi product); the only dropped term is the
    df64 cross term xlo*c.lo (~2^-48 relative), as in mul_relaxed."""
    p = xhi * c.hi
    err = ((xh * c.hh - p) + xh * c.hl + xl * c.hh) + xl * c.hl
    return DF64(p, err + (xhi * c.lo + xlo * c.hi))


def cmul_const_relaxed(x: CDF64, c: CDF64Const) -> CDF64:
    rh, rl = _split(x.re.hi)
    ih, il = _split(x.im.hi)
    m_rr = _mul_const_split(x.re.hi, x.re.lo, rh, rl, c.re)
    m_ii = _mul_const_split(x.im.hi, x.im.lo, ih, il, c.im)
    m_ri = _mul_const_split(x.re.hi, x.re.lo, rh, rl, c.im)
    m_ir = _mul_const_split(x.im.hi, x.im.lo, ih, il, c.re)
    return CDF64(add_relaxed(m_rr, neg(m_ii)), add_relaxed(m_ri, m_ir))


def csub_relaxed(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(add_relaxed(x.re, neg(y.re)), add_relaxed(x.im, neg(y.im)))


def cmul_relaxed(x: CDF64, y: CDF64) -> CDF64:
    return CDF64(
        add_relaxed(mul_relaxed(x.re, y.re), neg(mul_relaxed(x.im, y.im))),
        add_relaxed(mul_relaxed(x.re, y.im), mul_relaxed(x.im, y.re)),
    )


# --------------------------------------- 12-bit-split constant multiply
#
# Every multiply in the convolution engine is by a CONSTANT table (FFT
# twiddles, the four-step twiddle T, the kernel spectrum H) — there are no
# value*value products anywhere on the hot path. That admits a cheaper
# error-free product than the presplit-Dekker form above: quantize the
# constant's leading part to 12 MANTISSA BITS on host (c = c12 + lo with
# |lo| <= ~2^-12|c|, lo itself f32 so the representation is exact to
# ~2^-36|c|). Then with the value's hi part Dekker-split once per complex
# multiply (xh + xl == x.hi, 12-bit halves):
#
#     x * c = xh*c12 + xl*c12 + x.hi*lo + x.lo*f32(c)
#              ^exact    ^exact   ^2^-36     ^2^-24|x.lo|
#
# Four multiplies and three adds per real product — no (xh*chh - p) error
# reconstruction chain — cutting a relaxed complex constant-multiply from
# ~96/70 (plain/presplit) to ~54 weighted f32 ops, and the table from 4
# planes (DF64Const) to 3.
#
# Error analysis (budget: <= 1 LSB @ 24-bit = 2^-24 output-relative;
# df64r measures 0.001 LSB, so ~10 bits of headroom exist):
# - hi channel (t1 = xh*c12) is EXACT; t2 exact; t3 rounds at 2^-36|xc|
#   plus the 2^-36 representation error of c; t4 rounds at 2^-24|x.lo*c|.
# - the lo channel is unnormalized and GROWS: |lo_out| ~ 2^-12|xc| +
#   |x.lo||c|, i.e. ~s * 2^-12 relative after s chained stages (vs
#   s * 2^-24 for df64r). lo-channel rounding is then ~2^-36 * s per op;
#   RMS-accumulated over the engine's ~40 stage passes this is ~2^-28
#   output-relative — two orders below the budget.
# - unlike a df64r-value shortcut, NO term is dropped: t4's factor f32(c)
#   equals c12 + lo up to 2^-24|c|, so the carried-lo cross term is
#   complete at 2^-24|x.lo||c| ~ 2^-48-level absolute.

class DF40Const(NamedTuple):
    """Constant planes for the 12-bit-split multiply: c ~= c12 + lo
    (c12 carries the top 12 mantissa bits), f = f32(c)."""

    c12: jnp.ndarray
    lo: jnp.ndarray
    f: jnp.ndarray


class CDF40Const(NamedTuple):
    re: DF40Const
    im: DF40Const


def const12_split_np(x64: np.ndarray) -> DF40Const:
    """Host-side split of float64 into (c12, lo, f) NumPy planes."""
    x64 = np.asarray(x64, np.float64)
    f = x64.astype(np.float32)
    t = np.float32(_SPLIT) * f
    c12 = (t - (t - f)).astype(np.float32)
    lo = (x64 - c12.astype(np.float64)).astype(np.float32)
    return DF40Const(c12, lo, f)


def cconst12_split_np(z64: np.ndarray) -> CDF40Const:
    z64 = np.asarray(z64, np.complex128)
    return CDF40Const(const12_split_np(z64.real), const12_split_np(z64.imag))


def conj_const12(c: CDF40Const) -> CDF40Const:
    return CDF40Const(c.re, DF40Const(-c.im.c12, -c.im.lo, -c.im.f))


def _mul_const12(x: DF64, xh, xl, c: DF40Const) -> DF64:
    """x * c given x.hi's shared Dekker split (xh + xl == x.hi)."""
    return DF64(xh * c.c12,
                xl * c.c12 + (x.hi * c.lo + x.lo * c.f))


def cmul_const12_relaxed(x: CDF64, c: CDF40Const) -> CDF64:
    rh, rl = _split(x.re.hi)
    ih, il = _split(x.im.hi)
    m_rr = _mul_const12(x.re, rh, rl, c.re)
    m_ii = _mul_const12(x.im, ih, il, c.im)
    m_ri = _mul_const12(x.re, rh, rl, c.im)
    m_ir = _mul_const12(x.im, ih, il, c.re)
    return CDF64(add_relaxed(m_rr, neg(m_ii)), add_relaxed(m_ri, m_ir))


def mul_sconst12(x: DF64, c12: float, c_lo: float, c_f: float) -> DF64:
    """x * scalar-constant via the 12-bit split (for omega_8 rotations)."""
    xh, xl = _split(x.hi)
    return _mul_const12(x, xh, xl,
                        DF40Const(jnp.float32(c12), jnp.float32(c_lo),
                                  jnp.float32(c_f)))


def sconst12(x64: float) -> tuple[float, float, float]:
    """Host 12-bit split of a scalar constant -> (c12, lo, f)."""
    p = const12_split_np(np.asarray([x64]))
    return float(p.c12[0]), float(p.lo[0]), float(p.f[0])
