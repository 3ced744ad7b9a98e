"""Generic Stockham FFT over pluggable complex arithmetic.

The framework's own FFTs in plain JAX, selectable as the ``fourstep``,
``pease`` and ``stockham`` engines of :mod:`.overlap_save` beside the
default ``fft`` engine (``jnp.fft``). They run over explicit arithmetic:

- ``ARITH_F32``:  complex as a (re, im) float32 pair — the fast path.
- ``ARITH_DF64``: complex as a pair of double-floats (:mod:`.df64`) —
  the high-precision path (<= 1 LSB @ 24-bit, BASELINE.md north star).

The algorithm is a radix-2 decimation-in-frequency Stockham autosort FFT:
self-sorting (no bit-reversal gather), every stage a pure elementwise
butterfly over a [.., eta, s] view, fully fusable by XLA. The stage loop is unrolled at trace time (log2 n stages).
Real transforms use the standard two-for-one packing (pack even/odd samples
into a complex signal of half length, then untangle).

Complex dtypes are never used: explicit pairs let the same code serve
double-float.

Accuracy (fused end-to-end rfft*H->irfft, vs float64 NumPy):
- Where float32 arithmetic is strict IEEE (no contraction of a multiply
  and an add into an FMA, no reassociation), the df64 path lands at 0.50
  ulp32 of the output scale — the unavoidable final float32 rounding.
  f32 path = ~4.5 ulp32. On the GPU, chip_smoke.py gates every engine at
  production width (<= 1 LSB @ 24-bit high, <= 1 LSB @ 16-bit fast).
- CPU (test backend): df64 path degrades to ~1.5 ulp32 because XLA:CPU's
  LLVM emitter evaluates fused f32 chains with excess intermediate precision,
  which neutralizes error-free transformations (two_sum compensation terms
  collapse). Verified empirically: materializing any intermediate restores
  0.50 ulp; no XLA flag (--xla_allow_excess_precision=false,
  --xla_cpu_enable_fast_math=false) changes it. CPU tests therefore use a
  relaxed (but still sub-3-LSB@24-bit) tolerance for these engines; the
  1-LSB@24-bit BASELINE.md gate is asserted on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import df64 as dd


def _tmap(f, *trees):
    return jax.tree.map(f, *trees)


# --------------------------------------------------------------- arithmetic

class C32(NamedTuple):
    """Plain complex-as-pair-of-float32 (a JAX pytree)."""

    re: jnp.ndarray
    im: jnp.ndarray


class _ArithF32:
    """Complex ops on C32. Cheap, ~24-bit mantissa.

    Every arith also provides a CONSTANT-table interface: tables built by
    ``make_const_np`` are consumed only by ``mul_const``/``conj_const``.
    For f32 and strict df64 these alias the plain representation; the
    relaxed df64 arith stores presplit planes (df64.DF64Const) so code
    that loads tables at run time (not XLA-foldable constants) skips the
    constant's Dekker split.
    """

    name = "f32"
    T = C32

    @staticmethod
    def wrap_np(z64: np.ndarray):
        z64 = np.asarray(z64, np.complex128)
        return C32(z64.real.astype(np.float32), z64.imag.astype(np.float32))

    @staticmethod
    def from_f32(re, im):
        return C32(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))

    @staticmethod
    def to_f32(z):
        return z.re, z.im

    @staticmethod
    def add(a, b):
        return C32(a.re + b.re, a.im + b.im)

    @staticmethod
    def sub(a, b):
        return C32(a.re - b.re, a.im - b.im)

    @staticmethod
    def mul(a, b):
        return C32(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re)

    @staticmethod
    def conj(a):
        return C32(a.re, -a.im)

    @staticmethod
    def mul_neg_i(a):
        """(re, im) * -i = (im, -re)."""
        return C32(a.im, -a.re)

    @staticmethod
    def mul_pow2(a, c: float):
        c = jnp.float32(c)
        return C32(a.re * c, a.im * c)

    @staticmethod
    def mul_rsqrt2(a):
        s = jnp.float32(_RSQRT2_64)
        return C32(a.re * s, a.im * s)

    # constant-table interface (aliases the plain representation)
    make_const_np = None  # bound below (= wrap_np)
    mul_const = None      # bound below (= mul)
    conj_const = None     # bound below (= conj)


class _ArithDF64:
    """Complex ops on CDF64 (double-float pairs, ~49-bit mantissa)."""

    name = "df64"
    T = dd.CDF64

    wrap_np = staticmethod(dd.csplit_np)
    add = staticmethod(dd.cadd)
    sub = staticmethod(dd.csub)
    mul = staticmethod(dd.cmul)
    conj = staticmethod(dd.cconj)
    mul_pow2 = staticmethod(dd.cmul_pow2)

    @staticmethod
    def from_f32(re, im):
        return dd.cfrom_f32(re, im)

    @staticmethod
    def to_f32(z):
        return z.re.hi + z.re.lo, z.im.hi + z.im.lo

    @staticmethod
    def mul_neg_i(a):
        return dd.cneg_im(a)

    @staticmethod
    def mul_rsqrt2(a):
        return dd.CDF64(dd.mul_dconst(a.re, _RSQRT2_HI, _RSQRT2_LO),
                        dd.mul_dconst(a.im, _RSQRT2_HI, _RSQRT2_LO))

    make_const_np = None  # bound below (= wrap_np)
    mul_const = None      # bound below (= mul)
    conj_const = None     # bound below (= conj)


class _ArithDF64Relaxed(_ArithDF64):
    """df64 with unnormalized intermediates (df64.py 'relaxed' ops):
    ~25% fewer flops. Constant tables are PRESPLIT
    (df64.DF64Const planes; fewer flops per complex constant-multiply
    where tables are loaded at run time). Accuracy
    margin analyzed at df64.add_relaxed / cmul_const_relaxed; gated by
    the same oracle tests and the hardware fidelity gate as the strict
    path."""

    name = "df64r"

    add = staticmethod(dd.cadd_relaxed)
    sub = staticmethod(dd.csub_relaxed)
    mul = staticmethod(dd.cmul_relaxed)

    make_const_np = staticmethod(dd.cconst_split_np)
    mul_const = staticmethod(dd.cmul_const_relaxed)
    conj_const = staticmethod(dd.conj_const)

    @staticmethod
    def mul_rsqrt2(a):
        return dd.CDF64(
            dd.mul_dconst_relaxed(a.re, _RSQRT2_HI, _RSQRT2_LO),
            dd.mul_dconst_relaxed(a.im, _RSQRT2_HI, _RSQRT2_LO))

    @staticmethod
    def to_f32(z):
        # hi is no longer guaranteed to dominate lo after relaxed chains;
        # the plain sum still rounds the represented value correctly.
        return z.re.hi + z.re.lo, z.im.hi + z.im.lo


class _ArithDF40(_ArithDF64Relaxed):
    """Relaxed df64 VALUE arithmetic with 12-BIT-SPLIT constant tables
    (df64.DF40Const planes: c12 + lo + f32(c)). Every hot-path multiply
    is by a constant, and quantizing the constant's leading part to 12
    mantissa bits makes both value-half products error-free WITHOUT the
    Dekker error-reconstruction chain — a complex constant-multiply drops
    from ~70 (presplit df64r) to ~54 weighted f32 ops, and tables from 4
    planes to 3. Accuracy ~2^-30 worst-case per op (error analysis at
    df64.cmul_const12_relaxed), far below the <= 1 LSB @ 24-bit gate.
    Same oracle gates as every arith."""

    name = "df40"

    make_const_np = staticmethod(dd.cconst12_split_np)
    mul_const = staticmethod(dd.cmul_const12_relaxed)
    conj_const = staticmethod(dd.conj_const12)

    @staticmethod
    def mul_rsqrt2(a):
        c = _RSQRT2_C12
        return dd.CDF64(dd.mul_sconst12(a.re, *c), dd.mul_sconst12(a.im, *c))


_ArithF32.make_const_np = _ArithF32.wrap_np
_ArithF32.mul_const = _ArithF32.mul
_ArithF32.conj_const = _ArithF32.conj
_ArithDF64.make_const_np = _ArithDF64.wrap_np
_ArithDF64.mul_const = _ArithDF64.mul
_ArithDF64.conj_const = _ArithDF64.conj

ARITH_F32 = _ArithF32
ARITH_DF64 = _ArithDF64
ARITH_DF64_RELAXED = _ArithDF64Relaxed
ARITH_DF40 = _ArithDF40

_ARITHS = {"f32": ARITH_F32, "df64": ARITH_DF64, "df64r": ARITH_DF64_RELAXED,
           "df40": ARITH_DF40}


def arith_by_name(name: str):
    return _ARITHS[name]

# 1/sqrt(2) as a double-float constant (for the radix-8 omega_8 rotations).
_RSQRT2_64 = 1.0 / np.sqrt(2.0)
_RSQRT2_HI = float(np.float32(_RSQRT2_64))
_RSQRT2_LO = float(np.float64(_RSQRT2_64) - np.float64(np.float32(_RSQRT2_64)))
_RSQRT2_C12 = dd.sconst12(_RSQRT2_64)  # (c12, lo, f) for the df40 arith


def _w8_1(a, arith):
    """a * omega_8 = a * (1 - i)/sqrt(2)   (forward)."""
    v = arith.mul_neg_i(a)  # (im, -re)
    return arith.mul_rsqrt2(arith.add(a, v))


def _w8_3(a, arith):
    """a * omega_8^3 = a * (-1 - i)/sqrt(2)   (forward)."""
    v = arith.mul_neg_i(a)
    return arith.mul_rsqrt2(arith.sub(v, a))


def _w8_1c(a, arith):
    """a * conj(omega_8) = a * (1 + i)/sqrt(2)   (inverse)."""
    v = arith.mul_neg_i(a)
    return arith.mul_rsqrt2(arith.sub(a, v))


def _w8_3c(a, arith):
    """a * conj(omega_8^3) = a * (-1 + i)/sqrt(2)   (inverse)."""
    v = arith.mul_neg_i(a)
    return arith.mul_rsqrt2(arith.mul_pow2(arith.add(a, v), -1.0))


def _mul_pos_i(a, arith):
    """a * i = -((-i) * a)."""
    return arith.mul_neg_i(arith.mul_pow2(a, -1.0))


# ----------------------------------------------------------------- twiddles

@functools.lru_cache(maxsize=64)
def _stage_twiddles(n: int, arith_name: str):
    """Per-stage DIF twiddles w[p] = exp(-2*pi*i*p/eta), shape [eta2, 1].

    Cached as NumPy-backed values: device arrays created inside a jit trace
    would leak tracers through this cache; NumPy constants are re-embedded
    safely in every trace.
    """
    arith = arith_by_name(arith_name)
    stages = []
    eta = n
    while eta > 1:
        eta2 = eta // 2
        p = np.arange(eta2, dtype=np.float64)
        w = np.exp(-2j * np.pi * p / eta).reshape(eta2, 1)
        stages.append(arith.wrap_np(w))
        eta = eta2
    return tuple(stages)


@functools.lru_cache(maxsize=64)
def _untangle_twiddles(n: int, arith_name: str):
    """W1[k] = exp(-2*pi*i*k/n), k = 0..n/2, and its conjugate."""
    arith = arith_by_name(arith_name)
    k = np.arange(n // 2 + 1, dtype=np.float64)
    w1 = np.exp(-2j * np.pi * k / n)
    return arith.wrap_np(w1), arith.wrap_np(np.conj(w1))


# ---------------------------------------------------------------- the FFTs

def fft(z, n: int, arith=ARITH_DF64):
    """Complex DIF Stockham FFT over the last axis (natural order in/out)."""
    batch = jax.tree.leaves(z)[0].shape[:-1]
    x = z
    eta, s = n, 1
    for w in _stage_twiddles(n, arith.name):
        eta2 = eta // 2
        xv = _tmap(lambda a: a.reshape(batch + (eta, s)), x)
        a_ = _tmap(lambda t: t[..., :eta2, :], xv)
        b_ = _tmap(lambda t: t[..., eta2:, :], xv)
        even = arith.add(a_, b_)
        odd = arith.mul(arith.sub(a_, b_), w)
        x = _tmap(
            lambda e, o: jnp.stack([e, o], axis=-2).reshape(batch + (eta2, 2 * s)),
            even, odd,
        )
        eta, s = eta2, 2 * s
    return _tmap(lambda a: a.reshape(batch + (n,)), x)


def ifft(z, n: int, arith=ARITH_DF64):
    """Inverse complex FFT: conj(fft(conj(z))) / n (n a power of two)."""
    y = fft(arith.conj(z), n, arith)
    return arith.mul_pow2(arith.conj(y), 1.0 / n)


def _reverse(z):
    return _tmap(lambda a: a[..., ::-1], z)


def _ext(z):
    """Append bin 0 at the end (Z[n2] = Z[0] for the untangle step)."""
    return _tmap(lambda a: jnp.concatenate([a, a[..., :1]], axis=-1), z)


def rfft(x: jnp.ndarray, arith=ARITH_DF64):
    """Real float32 [.., n] -> spectrum [.., n/2+1] via two-for-one packing."""
    n = x.shape[-1]
    n2 = n // 2
    z = arith.from_f32(x[..., 0::2], x[..., 1::2])
    Z = fft(z, n2, arith)
    Zext = _ext(Z)
    Zrev = arith.conj(_reverse(Zext))
    E = arith.mul_pow2(arith.add(Zext, Zrev), 0.5)
    O = arith.mul_neg_i(arith.mul_pow2(arith.sub(Zext, Zrev), 0.5))
    w1, _ = _untangle_twiddles(n, arith.name)
    return arith.add(E, arith.mul(w1, O))


def irfft(X, n: int, arith=ARITH_DF64) -> jnp.ndarray:
    """Spectrum [.., n/2+1] -> real float32 [.., n]."""
    n2 = n // 2
    Xrev = arith.conj(_reverse(X))
    E = arith.mul_pow2(arith.add(X, Xrev), 0.5)
    _, w1c = _untangle_twiddles(n, arith.name)
    O = arith.mul(arith.mul_pow2(arith.sub(X, Xrev), 0.5), w1c)
    # Z = E + i*O, dropping the redundant Nyquist bin.
    Zi = _zip_ei(E, O, n2, arith)
    z = ifft(Zi, n2, arith)
    re, im = arith.to_f32(z)
    return jnp.stack([re, im], axis=-1).reshape(re.shape[:-1] + (n,))


def _zip_ei(E, O, n2: int, arith):
    """Z = E + i*O, truncated to n2 bins, in the arith's representation."""
    iO = arith.mul_neg_i(arith.mul_pow2(O, -1.0))  # i*O = -(-i*O)
    Z = arith.add(E, iO)
    return _tmap(lambda a: a[..., :n2], Z)


def rfft_multiply_irfft(blocks: jnp.ndarray, H, arith=ARITH_DF64) -> jnp.ndarray:
    """Fused overlap-save spectral step: irfft(rfft(blocks) * H).

    blocks: float32 [.., B]; H in the arith's representation, [B/2+1].
    The equivalent of the reference's entire hot loop
    (/root/reference/FilterCore.h:64-69) for one block.
    """
    n = blocks.shape[-1]
    X = rfft(blocks, arith)
    Y = arith.mul(X, H)
    return irfft(Y, n, arith)


# ------------------------------------------------------- constant geometry

"""Constant-geometry (Pease) FFT path.

The unrolled Stockham graph above has log2(n) distinct stage shapes and
is slow to compile. The Pease
formulation uses the IDENTICAL butterfly + interleave pattern every stage —
expressible as a `lax.fori_loop` whose body is ONE stage with twiddles
looked up from a precomputed [stages, n/2] table — cutting the graph (and
compile time) by ~the stage count.

Stage s (DIF): y[2j] = x[j] + x[j+n/2];  y[2j+1] = (x[j] - x[j+n/2]) * W_s[j]
with W_s[j] = exp(-2*pi*i * (j >> s) * 2^s / n). The output is in a fixed
permutation of the DFT — never materialized: the frequency response is
transformed with the same permuted FFT on host (float64), the pointwise
multiply happens in permuted order, and the inverse loop (conjugate
twiddles, reversed stages, mirrored access) returns natural time order.
Validated round-trip + convolution-vs-np.fft in tests.

Real signals ride two-per-complex-FFT: convolution with a real kernel is
real-linear, so conv(x1 + i*x2, h) = conv(x1, h) + i*conv(x2, h) — no
untangle step at all.
"""


@functools.lru_cache(maxsize=64)
def _pease_plan(n: int):
    """Stage plan: one radix-2 stage first when log2(n) is odd, then
    radix-4 stages. Returns (has_r2, tuple of per-r4-stage bit offsets)."""
    L = n.bit_length() - 1
    has_r2 = (L % 2 == 1)
    done = 1 if has_r2 else 0
    dones = []
    while done < L:
        dones.append(done)
        done += 2
    return has_r2, tuple(dones)


@functools.lru_cache(maxsize=64)
def _pease_tables_np(n: int):
    """Host float64 twiddle tables: (w2 [n/2] | None, w4 [S, 3, n/4]).

    A stage that begins with `done` input bits consumed uses
    w_r[j] = exp(-2*pi*i * r * (j >> done) * 2^done / n).
    """
    has_r2, dones = _pease_plan(n)
    w2 = None
    if has_r2:
        j = np.arange(n // 2)
        w2 = np.exp(-2j * np.pi * (j >> 0) / n)
    w4 = None
    if dones:
        j = np.arange(n // 4)
        w4 = np.stack([
            np.stack([
                np.exp(-2j * np.pi * r * ((j >> d) << d) / n) for r in (1, 2, 3)
            ])
            for d in dones
        ])
    return w2, w4


@functools.lru_cache(maxsize=64)
def _pease_tables(n: int, arith_name: str):
    arith = arith_by_name(arith_name)
    w2, w4 = _pease_tables_np(n)
    return (None if w2 is None else arith.wrap_np(w2),
            None if w4 is None else arith.wrap_np(w4))


def pease_fft_np(x64: np.ndarray) -> np.ndarray:
    """Host reference/driver: permuted-order FFT in float64 (for H tables).
    Must mirror the device algorithm exactly (same stage order)."""
    n = x64.shape[-1]
    y = np.asarray(x64, complex).copy()
    w2, w4 = _pease_tables_np(n)
    has_r2, dones = _pease_plan(n)
    if has_r2:
        q = n // 2
        a, b = y[..., :q], y[..., q:]
        y = np.stack([a + b, (a - b) * w2], axis=-1).reshape(y.shape)
    for s in range(len(dones)):
        q = n // 4
        a, b, c, d = y[..., :q], y[..., q:2*q], y[..., 2*q:3*q], y[..., 3*q:]
        e0, e1, e2, e3 = a + c, a - c, b + d, -1j * (b - d)
        y = np.stack([e0 + e2, (e1 + e3) * w4[s, 0], (e0 - e2) * w4[s, 1],
                      (e1 - e3) * w4[s, 2]], axis=-1).reshape(y.shape)
    return y


def _index_stage(W, s):
    return _tmap(lambda a: jax.lax.dynamic_index_in_dim(a, s, 0, keepdims=False), W)


def _row(W, r):
    return _tmap(lambda a: a[r], W)


def fft_pease(z, n: int, arith=ARITH_DF64):
    """Forward mixed-radix constant-geometry FFT (permuted output order)."""
    w2, w4 = _pease_tables(n, arith.name)
    has_r2, dones = _pease_plan(n)
    batch = jax.tree.leaves(z)[0].shape[:-1]

    if has_r2:
        q = n // 2
        a = _tmap(lambda t: t[..., :q], z)
        b = _tmap(lambda t: t[..., q:], z)
        even = arith.add(a, b)
        odd = arith.mul(arith.sub(a, b), w2)
        z = _tmap(lambda e, o: jnp.stack([e, o], axis=-1).reshape(batch + (n,)),
                  even, odd)

    if dones:
        q = n // 4

        def body(s, x):
            ws = _index_stage(w4, s)  # [3, n/4]
            a = _tmap(lambda t: t[..., :q], x)
            b = _tmap(lambda t: t[..., q:2*q], x)
            c = _tmap(lambda t: t[..., 2*q:3*q], x)
            d = _tmap(lambda t: t[..., 3*q:], x)
            e0, e1 = arith.add(a, c), arith.sub(a, c)
            e2 = arith.add(b, d)
            e3 = arith.mul_neg_i(arith.sub(b, d))
            r0 = arith.add(e0, e2)
            r1 = arith.mul(arith.add(e1, e3), _row(ws, 0))
            r2 = arith.mul(arith.sub(e0, e2), _row(ws, 1))
            r3 = arith.mul(arith.sub(e1, e3), _row(ws, 2))
            return _tmap(
                lambda p0, p1, p2, p3: jnp.stack(
                    [p0, p1, p2, p3], axis=-1).reshape(batch + (n,)),
                r0, r1, r2, r3,
            )

        z = jax.lax.fori_loop(0, len(dones), body, z)
    return z


def ifft_pease(y, n: int, arith=ARITH_DF64):
    """Inverse of :func:`fft_pease` (consumes permuted order, natural out)."""
    w2, w4 = _pease_tables(n, arith.name)
    has_r2, dones = _pease_plan(n)
    batch = jax.tree.leaves(y)[0].shape[:-1]

    if dones:
        q = n // 4
        S = len(dones)

        def body(i, x):
            ws = _index_stage(w4, S - 1 - i)
            v = _tmap(lambda t: t.reshape(batch + (q, 4)), x)
            u0 = _tmap(lambda t: t[..., 0], v)
            u1 = arith.mul(_tmap(lambda t: t[..., 1], v), arith.conj(_row(ws, 0)))
            u2 = arith.mul(_tmap(lambda t: t[..., 2], v), arith.conj(_row(ws, 1)))
            u3 = arith.mul(_tmap(lambda t: t[..., 3], v), arith.conj(_row(ws, 2)))
            e0, e2m = arith.add(u0, u2), arith.sub(u0, u2)
            e1, e3m = arith.add(u1, u3), arith.sub(u1, u3)
            ie3m = arith.mul_neg_i(arith.mul_pow2(e3m, -1.0))  # i * e3m
            return _tmap(
                lambda p0, p1, p2, p3: jnp.concatenate(
                    [p0, p1, p2, p3], axis=-1),
                arith.add(e0, e1), arith.add(e2m, ie3m),
                arith.sub(e0, e1), arith.sub(e2m, ie3m),
            )

        y = jax.lax.fori_loop(0, S, body, y)

    if has_r2:
        q = n // 2
        v = _tmap(lambda t: t.reshape(batch + (q, 2)), y)
        e = _tmap(lambda t: t[..., 0], v)
        o = arith.mul(_tmap(lambda t: t[..., 1], v), arith.conj(w2))
        y = _tmap(lambda p, qq: jnp.concatenate([p, qq], axis=-1),
                  arith.add(e, o), arith.sub(e, o))

    return arith.mul_pow2(y, 1.0 / n)


# ----------------------------------------------- in-place DIF/DIT row stages

"""In-place DIF (forward) / DIT (inverse) radix-4 stages along axis -2.

The constant-geometry (Pease) row stages interleave their outputs
(forward) or deinterleave their inputs (inverse) at single-row
granularity, which lowers to strided row copies. The classic in-place
formulation avoids them: stage at distance d reads and writes CONTIGUOUS d-row blocks within
each group — forward emits digit-reversed row order, the DIT inverse
consumes it and emits natural order. The digit-reversal permutation is
handled exactly like the Pease one: never materialized, absorbed into the
host-side spectrum layout (``dif_sigma``).
"""


@functools.lru_cache(maxsize=64)
def dif_plan(n: int):
    """PRODUCTION stage plan, outermost-first: optional leading radix-2,
    then radix-4. Tuple of ("r2"|"r4"|"r8", d) with d the intra-group
    block length.

    The radix-8-greedy plan (:func:`dif_plan_r8`) has 3 stages per
    512-point phase instead of 5 and ~10% fewer df64 flops; which of the
    two is faster on the GPU is not measured.
    """
    L = n.bit_length() - 1
    stages = []
    if L % 2 == 1:
        stages.append(("r2", n // 2))
        n //= 2
    while n > 1:
        stages.append(("r4", n // 4))
        n //= 4
    return tuple(stages)


@functools.lru_cache(maxsize=64)
def dif_plan_r8(n: int):
    """Minimal-stage-count plan (ceil(L/3)): radix-8 greedy, radix-4 (and
    radix-2 only for n=2) absorbing the remainder. Kept as a selectable,
    tested variant. Pass as ``plan=`` to the dif/dit entry points."""
    L = n.bit_length() - 1
    if L == 0:
        return ()
    n8, n4, n2 = 0, 0, 0
    if L % 3 == 0:
        n8 = L // 3
    elif L % 3 == 2:
        n8, n4 = L // 3, 1
    elif L >= 4:          # L % 3 == 1
        n8, n4 = (L - 4) // 3, 2
    else:                 # L == 1
        n2 = 1
    stages = []
    for kind, lg, cnt in (("r8", 3, n8), ("r4", 2, n4), ("r2", 1, n2)):
        for _ in range(cnt):
            stages.append((kind, n >> lg))
            n >>= lg
    return tuple(stages)


@functools.lru_cache(maxsize=64)
def dif_plan_roll(n: int, roll_below: int = 16, base: str = "r4"):
    """Stage plan whose fine tail (block length < roll_below) is all
    radix-2 — mathematically ordinary ("r2", d) stages, shaped so fine
    stages are single-row butterflies instead of strided row slices. Host
    mirrors (dif_fft_np / dif_sigma / dif_tables_np) accept this plan
    unchanged. ``base``: coarse-stage plan family — "r4" (:func:`dif_plan`)
    or "r8" (:func:`dif_plan_r8`)."""
    stages = []
    for kind, d in (dif_plan(n) if base == "r4" else dif_plan_r8(n)):
        radix = {"r2": 2, "r4": 4, "r8": 8}[kind]
        if d >= roll_below:
            stages.append((kind, d))
        else:
            # decompose this stage's radix into r2 steps (output order
            # changes — absorbed by the plan-aware sigma/H/mirror)
            span = radix * d
            while span > d:
                span //= 2
                stages.append(("r2", span))
    return tuple(stages)


@functools.lru_cache(maxsize=64)
def dif_tables_np(n: int, plan=None):
    """Per-stage output twiddles w_r[j] = exp(-2*pi*i*r*j/(radix*d)),
    shaped [d, 1]: r2 -> (w1,); r4 -> (w1, w2, w3); r8 -> (w1..w7).
    A d == 1 stage's twiddles are all exactly 1 — the device stages skip
    the multiply entirely (tables still emitted for mirror symmetry)."""
    out = []
    for kind, d in plan if plan is not None else dif_plan(n):
        j = np.arange(d, dtype=np.float64)[:, None]
        radix = {"r2": 2, "r4": 4, "r8": 8}[kind]
        g = radix * d
        out.append(tuple(
            np.exp(-2j * np.pi * r * j / g) for r in range(1, radix)))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def dif_tables(n: int, arith_name: str, plan=None):
    """Stage twiddles in the arith's CONSTANT representation (consumed by
    ``arith.mul_const`` in the stage bodies)."""
    arith = arith_by_name(arith_name)
    return tuple(tuple(arith.make_const_np(w) for w in ws)
                 for ws in dif_tables_np(n, plan))


def dif_fft_np(x64: np.ndarray, plan=None) -> np.ndarray:
    """Host float64 mirror (digit-reversed output order), last axis.

    Stage r's output block is DFT_radix(a)[r] * w_r — computed here with a
    dense radix-point DFT matrix (float64; the device stages use the
    factored butterfly, which is algebraically identical)."""
    x = np.asarray(x64, complex).copy()
    n = x.shape[-1]
    if plan is None:
        plan = dif_plan(n)
    for (kind, d), ws in zip(plan, dif_tables_np(n, plan)):
        radix = {"r2": 2, "r4": 4, "r8": 8}[kind]
        rq = np.arange(radix)
        W = np.exp(-2j * np.pi * rq[:, None] * rq[None, :] / radix)
        v = x.reshape(x.shape[:-1] + (-1, radix, d))
        y = np.einsum("rq,...gqd->...grd", W, v)
        for r in range(1, radix):
            y[..., r, :] = y[..., r, :] * ws[r - 1][:, 0]
        x = y.reshape(x.shape)
    return x


@functools.lru_cache(maxsize=32)
def dif_sigma(n: int, plan=None) -> np.ndarray:
    """Permutation with dif_fft_np(x)[i] == DFT(x)[dif_sigma(i)] (same
    delta-function recovery as :func:`pease_sigma`)."""
    x = np.zeros(n)
    if n > 1:
        x[1] = 1.0
        y = dif_fft_np(x, plan)
        sig = np.round(-np.angle(y) * n / (2 * np.pi)).astype(np.int64) % n
    else:
        sig = np.zeros(1, np.int64)
    assert len(np.unique(sig)) == n
    return sig


def dif_stage(z, kind: str, d: int, ws, arith):
    """ONE in-place DIF stage along axis -2 of [..., n, V] (strided
    contiguous-block formulation). ``ws`` is the stage's twiddle tuple from
    :func:`dif_tables`. A d == 1 stage's twiddles are exactly 1, so its
    multiplies are skipped (XLA does not fold a mul by a materialized
    all-ones array)."""
    shp = jax.tree.leaves(z)[0].shape

    def back(*parts):
        return _tmap(
            lambda *ps: jnp.stack(ps, axis=-3).reshape(shp), *parts)

    def tw(y, r):
        return y if d == 1 else arith.mul_const(y, ws[r - 1])

    radix = {"r2": 2, "r4": 4, "r8": 8}[kind]
    v = _tmap(lambda t: t.reshape(
        t.shape[:-2] + (-1, radix, d, t.shape[-1])), z)
    part = [_tmap(lambda t, q=q: t[..., q, :, :], v)
            for q in range(radix)]

    if kind == "r2":
        a, b = part
        return back(arith.add(a, b), tw(arith.sub(a, b), 1))
    if kind == "r4":
        a, b, c, e = part
        t0, t1 = arith.add(a, c), arith.sub(a, c)
        t2 = arith.add(b, e)
        t3 = arith.mul_neg_i(arith.sub(b, e))
        return back(
            arith.add(t0, t2),
            tw(arith.add(t1, t3), 1),
            tw(arith.sub(t0, t2), 2),
            tw(arith.sub(t1, t3), 3),
        )
    # Radix-8 DIF butterfly: y_r = DFT_8(a)[r], then *w_r.
    b0 = [arith.add(part[q], part[q + 4]) for q in range(4)]
    b1 = [arith.sub(part[q], part[q + 4]) for q in range(4)]
    # even outputs: DFT_4 of b0
    c0, c1 = arith.add(b0[0], b0[2]), arith.sub(b0[0], b0[2])
    c2 = arith.add(b0[1], b0[3])
    c3 = arith.mul_neg_i(arith.sub(b0[1], b0[3]))
    y0, y2 = arith.add(c0, c2), arith.add(c1, c3)
    y4, y6 = arith.sub(c0, c2), arith.sub(c1, c3)
    # odd outputs: DFT_4 of (omega_8^q * b1[q])
    d0 = b1[0]
    d1 = _w8_1(b1[1], arith)
    d2 = arith.mul_neg_i(b1[2])
    d3 = _w8_3(b1[3], arith)
    e0, e1 = arith.add(d0, d2), arith.sub(d0, d2)
    e2 = arith.add(d1, d3)
    e3 = arith.mul_neg_i(arith.sub(d1, d3))
    y1, y3 = arith.add(e0, e2), arith.add(e1, e3)
    y5, y7 = arith.sub(e0, e2), arith.sub(e1, e3)
    return back(y0, tw(y1, 1), tw(y2, 2), tw(y3, 3),
                tw(y4, 4), tw(y5, 5), tw(y6, 6), tw(y7, 7))


def dit_stage(y, kind: str, d: int, ws, arith):
    """ONE in-place DIT (inverse) stage along axis -2 — the inverse of
    :func:`dif_stage` WITHOUT the final 1/n scaling (callers apply it once
    per transform)."""
    shp = jax.tree.leaves(y)[0].shape

    def back(*parts):
        return _tmap(
            lambda *ps: jnp.stack(ps, axis=-3).reshape(shp), *parts)

    radix = {"r2": 2, "r4": 4, "r8": 8}[kind]
    v = _tmap(lambda t: t.reshape(
        t.shape[:-2] + (-1, radix, d, t.shape[-1])), y)
    # u_r = in_r * conj(w_r); a d == 1 stage's twiddles are exactly 1.
    u = [_tmap(lambda t, r=r: t[..., r, :, :], v) for r in range(radix)]
    if d > 1:
        u = [u[0]] + [arith.mul_const(u[r], arith.conj_const(ws[r - 1]))
                      for r in range(1, radix)]

    if kind == "r2":
        return back(arith.add(u[0], u[1]), arith.sub(u[0], u[1]))
    if kind == "r4":
        s0, d0 = arith.add(u[0], u[2]), arith.sub(u[0], u[2])
        s1, d1 = arith.add(u[1], u[3]), arith.sub(u[1], u[3])
        id1 = _mul_pos_i(d1, arith)
        return back(
            arith.add(s0, s1), arith.add(d0, id1),
            arith.sub(s0, s1), arith.sub(d0, id1),
        )
    # Radix-8 DIT: a_m = IDFT_4(even u)[m] + omega_8^{+m} IDFT_4(odd
    # u)[m] (and - for m+4).
    def idft4(v0, v1, v2, v3):
        s0, d0 = arith.add(v0, v2), arith.sub(v0, v2)
        s1 = arith.add(v1, v3)
        id1 = _mul_pos_i(arith.sub(v1, v3), arith)
        return (arith.add(s0, s1), arith.add(d0, id1),
                arith.sub(s0, s1), arith.sub(d0, id1))

    p = idft4(u[0], u[2], u[4], u[6])
    q = idft4(u[1], u[3], u[5], u[7])
    t = (q[0], _w8_1c(q[1], arith), _mul_pos_i(q[2], arith),
         _w8_3c(q[3], arith))
    return back(*[arith.add(p[m], t[m]) for m in range(4)],
                *[arith.sub(p[m], t[m]) for m in range(4)])


def fft_dif_rows(z, n: int, arith=ARITH_DF64, tabs=None, plan=None):
    """In-place DIF along axis -2 of [..., n, V]; digit-reversed rows out.

    ``tabs`` defaults to embedded host constants; callers may pass loaded
    table values instead."""
    if plan is None:
        plan = dif_plan(n)
    if tabs is None:
        tabs = dif_tables(n, arith.name, plan)
    for (kind, d), ws in zip(plan, tabs):
        z = dif_stage(z, kind, d, ws, arith)
    return z


def ifft_dit_rows(y, n: int, arith=ARITH_DF64, tabs=None, plan=None):
    """Inverse of :func:`fft_dif_rows`: digit-reversed rows in, natural
    out, 1/n scaling included. Contiguous block accesses in every stage."""
    if plan is None:
        plan = dif_plan(n)
    if tabs is None:
        tabs = dif_tables(n, arith.name, plan)
    for (kind, d), ws in zip(reversed(plan), reversed(tabs)):
        y = dit_stage(y, kind, d, ws, arith)
    return arith.mul_pow2(y, 1.0 / n)


@functools.lru_cache(maxsize=16)
def _fourstep_dif_twiddle_np(r: int, c: int, plan_r=None) -> np.ndarray:
    """T[i, n2] = W_(r*c)^(dif_sigma_r(i) * n2) (DIF-ordered rows)."""
    sig = dif_sigma(r, plan_r)
    i = sig[:, None].astype(np.float64)
    n2 = np.arange(c, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * i * n2 / (r * c))


def fourstep_dif_fft_np(x64: np.ndarray, r: int, c: int,
                        plan_r=None, plan_c=None) -> np.ndarray:
    """Host mirror of the DIF-based four-step (the fourstep engine's layout):
    [.., r*c] -> [.., c, r] with Y[j, i] = X[sig_r(i) + r*sig_c(j)]."""
    a = np.asarray(x64, complex).reshape(x64.shape[:-1] + (r, c))
    ahat = np.swapaxes(dif_fft_np(np.swapaxes(a, -1, -2), plan_r), -1, -2)
    m = ahat * _fourstep_dif_twiddle_np(r, c, plan_r)
    return np.swapaxes(dif_fft_np(m, plan_c), -1, -2)


# ------------------------------------------------------ four-step (2-D) FFT

"""Four-step constant-geometry FFT.

The 1-D Pease loop interleaves at granularity 1 every stage. The four-step
factorization B = R*C avoids that: every butterfly runs along axis -2 of a
[R, C] / [C, R] view, so each stage's interleave moves whole contiguous
rows, and the only cross-row relayout in the entire transform is ONE
transpose.

Decomposition (n = C*n1 + n2, k = k1 + R*k2):
  phase 1  DFT_R over n1: Pease stages along axis -2 of [R, C]
           -> rows in the fixed Pease permutation sigma_R
  twiddle  T[i, n2] = W_B^(sigma_R(i) * n2)
  swap     [R, C] -> [C, R]
  phase 2  DFT_C over n2: same row-axis Pease stages
Output layout Y[j, i] = X[sigma_R(i) + R*sigma_C(j)] — a fixed permutation
that is never materialized: H is transformed into the same layout on host
(float64, :func:`fourstep_fft_np`), the spectral multiply happens in that
layout, and the inverse (conjugate twiddles, reversed stages) returns
natural time order.
"""


def fourstep_split(n: int) -> tuple[int, int]:
    """Balanced power-of-two factorization n = R*C with R >= C (R is the
    row-batch width of phase 2, C of phase 1)."""
    lb = n.bit_length() - 1
    c = 1 << (lb // 2)
    return n // c, c


@functools.lru_cache(maxsize=32)
def pease_sigma(n: int) -> np.ndarray:
    """Permutation sigma with pease_fft_np(x)[i] == DFT(x)[sigma(i)].

    Recovered analytically: for x = delta_1, DFT(x)[k] = W_n^k, so the bin
    index is read off each output's phase. Exact for any practical n (bin
    phases are separated by 2*pi/n >> float64 angle error)."""
    x = np.zeros(n)
    if n > 1:
        x[1] = 1.0
        y = pease_fft_np(x)
        sig = np.round(-np.angle(y) * n / (2 * np.pi)).astype(np.int64) % n
    else:
        sig = np.zeros(1, np.int64)
    assert len(np.unique(sig)) == n
    return sig


@functools.lru_cache(maxsize=16)
def _fourstep_twiddle_np(r: int, c: int) -> np.ndarray:
    """T[i, n2] = W_(r*c)^(sigma_r(i) * n2) — phase-1-output-ordered rows."""
    sig = pease_sigma(r)
    i = sig[:, None].astype(np.float64)
    n2 = np.arange(c, dtype=np.float64)[None, :]
    return np.exp(-2j * np.pi * i * n2 / (r * c))


def fourstep_fft_np(x64: np.ndarray, r: int, c: int) -> np.ndarray:
    """Host float64 mirror of the device four-step: [.., r*c] -> [.., c, r]
    in the device's exact output layout (for H tables and tests)."""
    a = np.asarray(x64, complex).reshape(x64.shape[:-1] + (r, c))
    ahat = np.swapaxes(pease_fft_np(np.swapaxes(a, -1, -2)), -1, -2)
    m = ahat * _fourstep_twiddle_np(r, c)
    return np.swapaxes(pease_fft_np(m), -1, -2)


@functools.lru_cache(maxsize=64)
def _pease_tables_rows(n: int, arith_name: str):
    """Row-axis twiddles, shaped [.., q, 1] to broadcast over the row batch."""
    arith = arith_by_name(arith_name)
    w2, w4 = _pease_tables_np(n)
    return (None if w2 is None else arith.wrap_np(w2[:, None]),
            None if w4 is None else arith.wrap_np(w4[..., None]))


@functools.lru_cache(maxsize=16)
def _fourstep_twiddle(r: int, c: int, arith_name: str):
    arith = arith_by_name(arith_name)
    return arith.wrap_np(_fourstep_twiddle_np(r, c))


def fft_pease_rows(z, n: int, arith=ARITH_DF64):
    """Pease FFT along axis -2 of [..., n, V] (permuted row order out)."""
    w2, w4 = _pease_tables_rows(n, arith.name)
    has_r2, dones = _pease_plan(n)

    def _shp(t):
        return t.shape[:-2] + (n, t.shape[-1])

    if has_r2:
        q = n // 2
        a = _tmap(lambda t: t[..., :q, :], z)
        b = _tmap(lambda t: t[..., q:, :], z)
        even = arith.add(a, b)
        odd = arith.mul(arith.sub(a, b), w2)
        z = _tmap(lambda e, o: jnp.stack([e, o], axis=-2).reshape(_shp(e)),
                  even, odd)

    if dones:
        q = n // 4

        def body(s, x):
            ws = _index_stage(w4, s)  # [3, q, 1]
            a = _tmap(lambda t: t[..., 0 * q : 1 * q, :], x)
            b = _tmap(lambda t: t[..., 1 * q : 2 * q, :], x)
            c_ = _tmap(lambda t: t[..., 2 * q : 3 * q, :], x)
            d = _tmap(lambda t: t[..., 3 * q : 4 * q, :], x)
            e0, e1 = arith.add(a, c_), arith.sub(a, c_)
            e2 = arith.add(b, d)
            e3 = arith.mul_neg_i(arith.sub(b, d))
            r0 = arith.add(e0, e2)
            r1 = arith.mul(arith.add(e1, e3), _row(ws, 0))
            r2 = arith.mul(arith.sub(e0, e2), _row(ws, 1))
            r3 = arith.mul(arith.sub(e1, e3), _row(ws, 2))
            return _tmap(
                lambda p0, p1, p2, p3: jnp.stack(
                    [p0, p1, p2, p3], axis=-2).reshape(_shp(p0)),
                r0, r1, r2, r3)

        z = jax.lax.fori_loop(0, len(dones), body, z)
    return z


def ifft_pease_rows(y, n: int, arith=ARITH_DF64):
    """Inverse of :func:`fft_pease_rows` (permuted rows in, natural out)."""
    w2, w4 = _pease_tables_rows(n, arith.name)
    has_r2, dones = _pease_plan(n)

    if dones:
        q = n // 4
        S = len(dones)

        def body(i, x):
            ws = _index_stage(w4, S - 1 - i)
            v = _tmap(
                lambda t: t.reshape(t.shape[:-2] + (q, 4, t.shape[-1])), x)
            u0 = _tmap(lambda t: t[..., 0, :], v)
            u1 = arith.mul(_tmap(lambda t: t[..., 1, :], v),
                           arith.conj(_row(ws, 0)))
            u2 = arith.mul(_tmap(lambda t: t[..., 2, :], v),
                           arith.conj(_row(ws, 1)))
            u3 = arith.mul(_tmap(lambda t: t[..., 3, :], v),
                           arith.conj(_row(ws, 2)))
            e0, e2m = arith.add(u0, u2), arith.sub(u0, u2)
            e1, e3m = arith.add(u1, u3), arith.sub(u1, u3)
            ie3m = arith.mul_neg_i(arith.mul_pow2(e3m, -1.0))  # i * e3m
            return _tmap(
                lambda p0, p1, p2, p3: jnp.concatenate(
                    [p0, p1, p2, p3], axis=-2),
                arith.add(e0, e1), arith.add(e2m, ie3m),
                arith.sub(e0, e1), arith.sub(e2m, ie3m))

        y = jax.lax.fori_loop(0, S, body, y)

    if has_r2:
        q = n // 2
        v = _tmap(lambda t: t.reshape(t.shape[:-2] + (q, 2, t.shape[-1])), y)
        e = _tmap(lambda t: t[..., 0, :], v)
        o = arith.mul(_tmap(lambda t: t[..., 1, :], v), arith.conj(w2))
        y = _tmap(lambda p, qq: jnp.concatenate([p, qq], axis=-2),
                  arith.add(e, o), arith.sub(e, o))

    return arith.mul_pow2(y, 1.0 / n)


def fft_fourstep(z, n: int, arith=ARITH_DF64):
    """[.., n] complex -> [.., C, R] spectrum in the four-step layout."""
    r, c = fourstep_split(n)
    z = _tmap(lambda t: t.reshape(t.shape[:-1] + (r, c)), z)
    z = fft_pease_rows(z, r, arith)
    z = arith.mul(z, _fourstep_twiddle(r, c, arith.name))
    z = _tmap(lambda t: jnp.swapaxes(t, -1, -2), z)
    return fft_pease_rows(z, c, arith)


def ifft_fourstep(y, n: int, arith=ARITH_DF64):
    """[.., C, R] four-step-layout spectrum -> [.., n] natural complex."""
    r, c = fourstep_split(n)
    y = ifft_pease_rows(y, c, arith)
    y = _tmap(lambda t: jnp.swapaxes(t, -1, -2), y)
    y = arith.mul(y, arith.conj(_fourstep_twiddle(r, c, arith.name)))
    y = ifft_pease_rows(y, r, arith)
    return _tmap(lambda t: t.reshape(t.shape[:-2] + (r * c,)), y)


def fourstep_conv_real_blocks(blocks: jnp.ndarray, H2,
                              arith=ARITH_DF64) -> jnp.ndarray:
    """Circular convolution of real blocks with a real kernel, two blocks
    per complex FFT (same contract as :func:`pease_conv_real_blocks`) —
    the ``fourstep`` engine.

    Implementation: four-step factorization with in-place DIF (forward) /
    DIT (inverse) radix-4 row stages, Python-unrolled. Output is
    bit-identical to the fori_loop Pease-rows variant
    (:func:`fourstep_pease_conv_real_blocks`); every DIF/DIT stage reads
    and writes CONTIGUOUS d-row blocks instead of the Pease stages'
    single-row interleave, and unrolled stages drop the fori_loop `while`
    bookkeeping.

    ``H2`` is the kernel's DIF four-step-layout spectrum (host:
    ``fourstep_dif_fft_np(kernel_padded, R, C)``), [C, R] in the arith's
    representation.
    """
    nb, b = blocks.shape
    r, c = fourstep_split(b)
    T = _fourstep_dif_twiddle(r, c, arith.name)
    z = arith.from_f32(blocks[0::2], blocks[1::2])  # [nb/2, B] complex
    z = _tmap(lambda t: t.reshape(t.shape[:-1] + (r, c)), z)
    z = fft_dif_rows(z, r, arith)                 # phase 1 fwd (rows = R)
    z = arith.mul(z, T)
    z = _tmap(lambda t: jnp.swapaxes(t, -1, -2), z)
    z = fft_dif_rows(z, c, arith)                 # phase 2 fwd (rows = C)
    z = arith.mul(z, H2)                          # spectral multiply
    z = ifft_dit_rows(z, c, arith)                # phase 2 inv
    z = _tmap(lambda t: jnp.swapaxes(t, -1, -2), z)
    z = arith.mul(z, arith.conj(T))
    z = ifft_dit_rows(z, r, arith)                # phase 1 inv
    z = _tmap(lambda t: t.reshape(t.shape[:-2] + (b,)), z)
    re, im = arith.to_f32(z)
    return jnp.stack([re, im], axis=1).reshape(nb, b)


@functools.lru_cache(maxsize=16)
def _fourstep_dif_twiddle(r: int, c: int, arith_name: str):
    arith = arith_by_name(arith_name)
    return arith.wrap_np(_fourstep_dif_twiddle_np(r, c))


def fourstep_pease_conv_real_blocks(blocks: jnp.ndarray, H2,
                                    arith=ARITH_DF64) -> jnp.ndarray:
    """The fori_loop Pease-rows four-step variant (kept as a cross-check;
    ``H2`` here is the PEASE four-step layout, ``fourstep_fft_np``)."""
    nb, b = blocks.shape
    z = arith.from_f32(blocks[0::2], blocks[1::2])  # [nb/2, B] complex
    Z = fft_fourstep(z, b, arith)
    Y = arith.mul(Z, H2)
    y = ifft_fourstep(Y, b, arith)
    re, im = arith.to_f32(y)
    return jnp.stack([re, im], axis=1).reshape(nb, b)


def pease_conv_real_blocks(blocks: jnp.ndarray, Hp, arith=ARITH_DF64) -> jnp.ndarray:
    """Circular convolution of real blocks with a real kernel, two blocks per
    complex FFT: blocks [nb, B] float32 (nb even) -> [nb, B] float32.

    ``Hp`` is the kernel's PERMUTED-order spectrum (host:
    ``pease_fft_np(kernel_padded)``) in the arith's representation, [B].
    """
    nb, b = blocks.shape
    z = arith.from_f32(blocks[0::2], blocks[1::2])  # [nb/2, B] complex
    Z = fft_pease(z, b, arith)
    Y = arith.mul(Z, Hp)
    y = ifft_pease(Y, b, arith)
    re, im = arith.to_f32(y)
    return jnp.stack([re, im], axis=1).reshape(nb, b)
