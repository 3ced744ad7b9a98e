"""Double-float arithmetic + df64 FFT tests.

Asserts the error-free transformations actually hold under XLA
compilation (strict IEEE f32 required), and that the df64 FFT reaches
near-float64 accuracy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lowcut.ops import df64, fft_df64


def rand64(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-scale, scale, shape).astype(np.float64)


def test_split_roundtrip_exact():
    x = rand64(1000, seed=1)
    d = df64.df64_split_array(x)
    # hi + lo recovers x to the double-float mantissa width (~2^-48 rel).
    assert np.max(np.abs(df64.to_f64(d) - x)) <= np.max(np.abs(x)) * 2**-46


def test_two_sum_error_free_under_jit():
    @jax.jit
    def f(a, b):
        s, e = df64._two_sum(a, b)
        return s, e

    a = jnp.float32(1.0)
    b = jnp.float32(1e-8)  # lost entirely in plain f32 add
    s, e = f(a, b)
    assert float(s) == 1.0
    assert float(e) == pytest.approx(1e-8, rel=1e-6)
    assert float(np.float64(s) + np.float64(e)) == pytest.approx(1.0 + 1e-8, rel=0, abs=1e-17)


def test_two_prod_error_free_under_jit():
    @jax.jit
    def f(a, b):
        return df64._two_prod(a, b)

    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, 4096).astype(np.float32)
    b = rng.uniform(-1, 1, 4096).astype(np.float32)
    p, e = f(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)  # Dekker product is exact


@pytest.mark.parametrize("op,npop", [
    (df64.add, np.add), (df64.sub, np.subtract), (df64.mul, np.multiply),
])
def test_df64_ops_accuracy(op, npop):
    x = rand64(2048, seed=4)
    y = rand64(2048, seed=5)
    dx, dy = df64.df64_split_array(x), df64.df64_split_array(y)
    got = df64.to_f64(jax.jit(op)(dx, dy))
    want = npop(x, y)
    # Error is bounded relative to the operands (cancellation can make the
    # result arbitrarily small); operands themselves carry ~2^-48 split error.
    denom = np.maximum(np.abs(x), np.abs(y))
    assert np.max(np.abs(got - want) / denom) < 2**-44


def test_cmul_accuracy():
    z1 = rand64(512, seed=6) + 1j * rand64(512, seed=7)
    z2 = rand64(512, seed=8) + 1j * rand64(512, seed=9)
    d1, d2 = df64.csplit_array(z1), df64.csplit_array(z2)
    got = jax.jit(df64.cmul)(d1, d2)
    want = z1 * z2
    err = np.abs((df64.to_f64(got.re) + 1j * df64.to_f64(got.im)) - want)
    assert np.max(err) < np.max(np.abs(want)) * 2**-43


@pytest.mark.parametrize("n", [64, 1024, 16384])
def test_fft_cdf64_matches_numpy_f64(n):
    z = rand64(n, seed=10) + 1j * rand64(n, seed=11)
    zd = df64.csplit_array(z)
    got = jax.jit(lambda t: fft_df64.fft_cdf64(t, n))(zd)
    want = np.fft.fft(z)
    err = np.abs((df64.to_f64(got.re) + 1j * df64.to_f64(got.im)) - want)
    # df64 FFT error ~ eps_df64 * log2(n); bound generously at 2^-40 * n-norm
    assert np.max(err) < np.max(np.abs(want)) * 2**-38


@pytest.mark.parametrize("n", [256, 4096])
def test_rfft_irfft_df64_roundtrip(n):
    x = rand64(n, seed=12).astype(np.float32)
    X = jax.jit(fft_df64.rfft_df64)(jnp.asarray(x))
    want = np.fft.rfft(x.astype(np.float64))
    err = np.abs((df64.to_f64(X.re) + 1j * df64.to_f64(X.im)) - want)
    assert np.max(err) < np.max(np.abs(want)) * 2**-38
    back = jax.jit(lambda t: fft_df64.irfft_df64(t, n))(X)
    # Round-trip back to the original float32 samples: exact to f32 rounding.
    np.testing.assert_allclose(np.asarray(back), x, rtol=0, atol=2**-22 * np.max(np.abs(x)))


def test_rfft_multiply_irfft_convolution_accuracy():
    """Full spectral step vs float64 numpy: the engine's accuracy core."""
    n = 8192
    x = rand64(n, seed=13).astype(np.float32)
    h = rand64(n, seed=14) * np.exp(-np.arange(n) / 50.0)  # decaying kernel
    H = df64.csplit_array(np.fft.rfft(h))
    got = np.asarray(
        jax.jit(fft_df64.rfft_multiply_irfft)(jnp.asarray(x)[None, :], H)
    )[0]
    want = np.fft.irfft(np.fft.rfft(x.astype(np.float64)) * np.fft.rfft(h), n)
    scale = np.max(np.abs(want))
    # must be at float32-cast accuracy: the df64 pipeline error is far below
    # the final f32 rounding of the output.
    assert np.max(np.abs(got - want)) < scale * 2**-22


# ---------------------------------------------------- constant-geometry FFT

@pytest.mark.parametrize("n", [64, 4096])
@pytest.mark.parametrize("arith_name", ["f32", "df64"])
def test_pease_roundtrip_and_convolution(n, arith_name):
    from lowcut.ops import fft_core

    arith = fft_core.ARITH_F32 if arith_name == "f32" else fft_core.ARITH_DF64
    rng = np.random.default_rng(21)
    x1 = rng.uniform(-1, 1, n).astype(np.float32)
    x2 = rng.uniform(-1, 1, n).astype(np.float32)
    h = rng.standard_normal(n) * np.exp(-np.arange(n) / 40.0)
    Hp = jax.tree.map(jnp.asarray, arith.wrap_np(fft_core.pease_fft_np(h)))
    blocks = jnp.asarray(np.stack([x1, x2]))
    got = np.asarray(jax.jit(
        lambda b: fft_core.pease_conv_real_blocks(b, Hp, arith))(blocks))
    for xi, gi in ((x1, got[0]), (x2, got[1])):
        want = np.fft.irfft(np.fft.rfft(xi.astype(np.float64)) * np.fft.rfft(h), n)
        scale = np.max(np.abs(want))
        tol = scale * (2 ** -18 if arith_name == "f32" else 2 ** -21)
        assert np.max(np.abs(gi - want)) < tol


def test_pease_fft_np_is_permuted_dft():
    """Host pease_fft_np output is a fixed permutation of np.fft.fft."""
    from lowcut.ops import fft_core

    n = 256
    rng = np.random.default_rng(5)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = np.sort_complex(np.round(fft_core.pease_fft_np(z), 6))
    want = np.sort_complex(np.round(np.fft.fft(z), 6))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------ four-step FFT

def test_pease_sigma_is_exact_permutation():
    """sigma satisfies pease_fft_np(x)[i] == DFT(x)[sigma(i)] on random data."""
    from lowcut.ops import fft_core

    for n in (8, 64, 2048):
        sig = fft_core.pease_sigma(n)
        rng = np.random.default_rng(n)
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(
            fft_core.pease_fft_np(z), np.fft.fft(z)[sig], rtol=1e-9, atol=1e-9)


def test_fourstep_fft_np_matches_dft_layout():
    """Host four-step mirror == DFT re-indexed by (sigma_R, sigma_C)."""
    from lowcut.ops import fft_core

    n = 512
    r, c = fft_core.fourstep_split(n)
    rng = np.random.default_rng(9)
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = fft_core.fourstep_fft_np(z, r, c)  # [c, r]: Y[j,i]=X[sR(i)+r*sC(j)]
    X = np.fft.fft(z)
    sr, sc = fft_core.pease_sigma(r), fft_core.pease_sigma(c)
    want = X[sr[None, :] + r * sc[:, None]]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-7)


def test_dif_fft_np_is_permuted_dft_and_sigma_exact():
    """Host DIF mirror == DFT re-indexed by dif_sigma (all radix paths)."""
    from lowcut.ops import fft_core

    for n in (8, 64, 512):
        sig = fft_core.dif_sigma(n)
        rng = np.random.default_rng(n)
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        np.testing.assert_allclose(
            fft_core.dif_fft_np(z), np.fft.fft(z)[sig], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("plan_name", ["r4", "r8"])
def test_dif_rows_roundtrip_matches_mirror(n, plan_name):
    """Device DIF rows fwd == host mirror; DIT inverse restores input.

    Covers both the production r2+r4 plan and the radix-8-greedy variant
    (dif_plan_r8 — selectable, kept correct)."""
    from lowcut.ops import fft_core

    plan = (fft_core.dif_plan(n) if plan_name == "r4"
            else fft_core.dif_plan_r8(n))
    if plan_name == "r8":
        assert any(kind == "r8" for kind, _ in plan)
    arith = fft_core.ARITH_DF64
    rng = np.random.default_rng(31)
    v = 8
    xr = rng.standard_normal((2, n, v)).astype(np.float32)
    xi = rng.standard_normal((2, n, v)).astype(np.float32)
    z = arith.from_f32(jnp.asarray(xr), jnp.asarray(xi))
    Z = jax.jit(lambda t: fft_core.fft_dif_rows(t, n, arith, plan=plan))(z)
    got = (np.asarray(Z.re.hi + Z.re.lo)
           + 1j * np.asarray(Z.im.hi + Z.im.lo))
    want = fft_core.dif_fft_np(
        (xr + 1j * xi).transpose(0, 2, 1), plan).transpose(0, 2, 1)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
    # sigma must be a valid permutation for this plan too.
    sig = fft_core.dif_sigma(n, plan)
    assert len(np.unique(sig)) == n
    back = jax.jit(lambda t: fft_core.ifft_dit_rows(
        fft_core.fft_dif_rows(t, n, arith, plan=plan), n, arith,
        plan=plan))(z)
    np.testing.assert_allclose(
        np.asarray(back.re.hi + back.re.lo), xr, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [64, 512, 4096])
@pytest.mark.parametrize("arith_name", ["f32", "df64"])
def test_fourstep_roundtrip_and_convolution(n, arith_name):
    from lowcut.ops import fft_core

    arith = fft_core.ARITH_F32 if arith_name == "f32" else fft_core.ARITH_DF64
    rng = np.random.default_rng(22)
    x1 = rng.uniform(-1, 1, n).astype(np.float32)
    x2 = rng.uniform(-1, 1, n).astype(np.float32)
    h = rng.standard_normal(n) * np.exp(-np.arange(n) / 40.0)
    # Production engine (DIF layout) and the Pease-rows cross-check variant.
    H_dif = jax.tree.map(jnp.asarray, arith.wrap_np(
        fft_core.fourstep_dif_fft_np(h, *fft_core.fourstep_split(n))))
    H_pease = jax.tree.map(jnp.asarray, arith.wrap_np(
        fft_core.fourstep_fft_np(h, *fft_core.fourstep_split(n))))
    blocks = jnp.asarray(np.stack([x1, x2]))
    got = np.asarray(jax.jit(
        lambda b: fft_core.fourstep_conv_real_blocks(b, H_dif, arith))(blocks))
    got_pease = np.asarray(jax.jit(
        lambda b: fft_core.fourstep_pease_conv_real_blocks(
            b, H_pease, arith))(blocks))
    for xi, gi, gp in ((x1, got[0], got_pease[0]), (x2, got[1], got_pease[1])):
        want = np.fft.irfft(np.fft.rfft(xi.astype(np.float64)) * np.fft.rfft(h), n)
        scale = np.max(np.abs(want))
        tol = scale * (2 ** -18 if arith_name == "f32" else 2 ** -21)
        assert np.max(np.abs(gi - want)) < tol
        assert np.max(np.abs(gp - want)) < tol


def test_cmul_const_relaxed_accuracy():
    """Presplit constant multiply (df64.cmul_const_relaxed) vs complex128:
    same bound as the symmetric cmul (it drops only lo*lo terms)."""
    import jax

    from lowcut.ops import df64 as dd

    rng = np.random.default_rng(5)
    a64 = rng.uniform(-2, 2, 4096) + 1j * rng.uniform(-2, 2, 4096)
    c64 = np.exp(1j * rng.uniform(0, 2 * np.pi, 4096))  # unit twiddles
    a = dd.csplit_array(a64)
    c = jax.tree.map(jnp.asarray, dd.cconst_split_np(c64))
    # hh + hl must reconstruct hi exactly (error-free Dekker split)
    np.testing.assert_array_equal(
        np.asarray(c.re.hh) + np.asarray(c.re.hl), np.asarray(c.re.hi))
    got = jax.jit(dd.cmul_const_relaxed)(a, c)
    want = a64 * c64
    err = np.abs((dd.to_f64(got.re) + 1j * dd.to_f64(got.im)) - want)
    # XLA:CPU's excess-precision fusion sporadically breaks Dekker splits
    # (see fft_core.py docstring) — strict f32 hardware gets the true bound.
    from util import on_cpu
    tol = 2 ** -23 if on_cpu() else 2 ** -44
    assert err.max() < np.abs(want).max() * tol


def test_conj_const_negates_imaginary():
    from lowcut.ops import df64 as dd

    c = dd.cconst_split_np(np.array([1.25 + 2.5j, -0.5 - 0.125j]))
    cc = dd.conj_const(c)
    np.testing.assert_array_equal(np.asarray(cc.im.hi), -np.asarray(c.im.hi))
    np.testing.assert_array_equal(np.asarray(cc.im.hh), -np.asarray(c.im.hh))
    np.testing.assert_array_equal(np.asarray(cc.re.hi), np.asarray(c.re.hi))


# ------------------------------------------------- 12-bit-split const mul

from lowcut.ops import df64 as dd


def test_cmul_const12_accuracy():
    """The df40 constant multiply (df64.cmul_const12_relaxed): error vs the
    float64 product stays ~2^-30 per element even with lo channels grown to
    2^-8 of hi (far beyond what ~40 relaxed stages produce) and with
    re/im cancellation — two orders inside the 2^-26 engine budget."""
    import jax

    rng = np.random.default_rng(0)
    x64 = rng.uniform(-2, 2, 4096)
    xlo = (rng.uniform(-1, 1, 4096) * 2**-8 * np.abs(x64)).astype(np.float32)
    x = dd.DF64(np.float32(x64), xlo)
    xv = x.hi.astype(np.float64) + xlo.astype(np.float64)
    c64 = rng.uniform(-1, 1, 4096) + 1j * rng.uniform(-1, 1, 4096)
    c = jax.tree.map(jnp.asarray, dd.cconst12_split_np(c64))
    z = jax.tree.map(jnp.asarray,
                     dd.CDF64(x, dd.DF64(np.roll(np.float32(x64), 1),
                                         np.roll(xlo, 1))))
    zv = xv + 1j * np.roll(xv, 1)

    out = dd.cmul_const12_relaxed(z, c)
    got = (np.asarray(out.re.hi, np.float64) + np.asarray(out.re.lo, np.float64)
           + 1j * (np.asarray(out.im.hi, np.float64)
                   + np.asarray(out.im.lo, np.float64)))
    want = zv * c64
    assert np.max(np.abs(got - want) / np.abs(want)) < 2**-29

    outc = dd.cmul_const12_relaxed(z, dd.conj_const12(c))
    gotc = (np.asarray(outc.re.hi, np.float64)
            + np.asarray(outc.re.lo, np.float64)
            + 1j * (np.asarray(outc.im.hi, np.float64)
                    + np.asarray(outc.im.lo, np.float64)))
    wantc = zv * np.conj(c64)
    assert np.max(np.abs(gotc - wantc) / np.abs(wantc)) < 2**-29


def test_const12_split_representation():
    """c12 carries <= 12 mantissa bits (value-half products error-free) and
    c12 + lo reconstructs the f64 constant to ~2^-36 relative."""
    rng = np.random.default_rng(1)
    c64 = rng.uniform(-1, 1, 10000)
    p = dd.const12_split_np(c64)
    # exactness of 12x12-bit products: c12 * any 12-bit half fits f32
    m, e = np.frexp(p.c12[p.c12 != 0])
    assert np.all(m * 4096 == np.round(m * 4096))  # <= 12 mantissa bits
    rec = p.c12.astype(np.float64) + p.lo.astype(np.float64)
    assert np.max(np.abs(rec - c64)) < 2**-35
    assert np.array_equal(p.f, c64.astype(np.float32))


def test_mul_sconst12_rsqrt2():
    rng = np.random.default_rng(2)
    x64 = rng.uniform(-2, 2, 1000)
    x = dd.DF64(jnp.asarray(np.float32(x64)),
                jnp.asarray((x64 - np.float32(x64)).astype(np.float32)))
    c = 1.0 / np.sqrt(2.0)
    got = dd.mul_sconst12(x, *dd.sconst12(c))
    gv = np.asarray(got.hi, np.float64) + np.asarray(got.lo, np.float64)
    assert np.max(np.abs(gv - x64 * c) / np.abs(x64 * c)) < 2**-34
