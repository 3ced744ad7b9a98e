"""Overlap-save engine vs the float64 oracle (SURVEY.md §4.1-4.2).

Gate (SURVEY.md §7 step 4): high-precision path matches the oracle within
1 LSB @ 24-bit (the double-float engines are relaxed on the CPU test
backend — see fft_core.py's accuracy notes); fast path within 1 LSB @
16-bit. There is no matrix product on the device path, so TF32 never
applies to these gates. Edge zero-padding must be
identical to the reference's 3-phase semantics (tested via the oracle, which
is itself proven equal to the loop transliteration in test_oracle.py).

Tests use small kernels + explicit small block sizes to keep the unrolled
FFT graphs quick to compile; correctness properties are size-independent.
"""

import numpy as np
import pytest

from lowcut.ops import kernel_design as kd
from lowcut.ops import oracle
from lowcut.ops import overlap_save as osv

from lowcut.utils.options import ENGINES
from util import high_tol_lsb24


def make_case(n, fc=0.05, bw=0.02, seed=0, channels=None):
    ws = kd.WindowedSinc(fc, bw).make_low_cut()   # bw=0.02 -> 201 taps
    rng = np.random.default_rng(seed)
    shape = (n,) if channels is None else (channels, n)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    return x, ws


def test_choose_block_size():
    # Production kernels get the 2^18 floor; next_pow2(4M) above it.
    assert osv.choose_block_size(17641) == 1 << 18   # 44.1 kHz M=17640
    assert osv.choose_block_size(38401) == 1 << 18   # 96 kHz M=38400
    assert osv.choose_block_size(76801) == 1 << 19   # 192 kHz M=76800
    assert osv.choose_block_size(401) == 1 << 13     # min clamp (test-scale)
    assert osv.choose_block_size(401, requested=4096) == 4096
    with pytest.raises(ValueError):
        osv.choose_block_size(9000, requested=4096)


@pytest.mark.parametrize("precision,bits", [(osv.FAST, 16), (osv.HIGH, 24)])
def test_engine_matches_oracle(precision, bits):
    x, ws = make_case(n=6000, seed=1)
    plan = osv.make_plan(ws.taps, precision=precision, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x, ws.taps)
    tol = high_tol_lsb24() if bits == 24 else 1.0
    assert oracle.max_lsb_error(y, ref, bits=bits) <= tol


def test_engine_ulp_relative_bound_above_full_scale():
    """Output peaks in [2, 4): the precision promise is ULP-relative
    (<= 1 f32 ulp of the output's binade, fft_core._ArithDF40), so the
    scaled-LSB metric must stay bounded while the absolute metric doubles
    with the binade. Guards the gate against spuriously failing (or
    silently weakening) with signal scale — round-4 verdict item 5."""
    x, ws = make_case(n=6000, seed=11)
    x = np.float32(2.4) * x  # drives the filtered peak into [2, 4)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x, ws.taps)
    peak = float(np.abs(ref).max())
    assert 2.0 <= peak < 4.0, peak
    scaled = oracle.max_scaled_lsb_error(y, ref, bits=24)
    assert scaled <= high_tol_lsb24()
    # The scaled metric is exactly the absolute one divided by the binade.
    assert scaled == pytest.approx(
        oracle.max_lsb_error(y, ref, bits=24) / 2.0)


def test_scaled_lsb_metric_never_weaker_below_full_scale():
    """Sub-full-scale outputs keep the ABSOLUTE unit: quiet signals do not
    get a laxer gate."""
    a = np.float32([0.25 + 2.0 ** -23])
    b = np.float64([0.25])
    assert oracle.max_scaled_lsb_error(a, b, bits=24) == pytest.approx(
        oracle.max_lsb_error(a, b, bits=24))


@pytest.mark.parametrize("n", [100, 823, 824, 825, 5000])
def test_engine_lengths_and_edges(n):
    """Lengths around block boundaries (hop=824 at B=1024, T=201);
    edge zero-pad semantics exact."""
    x, ws = make_case(n=n, seed=2)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x, ws.taps)
    assert y.shape == ref.shape
    assert oracle.max_lsb_error(y, ref, bits=24) <= high_tol_lsb24()


def test_engine_multichannel_matches_per_channel():
    x, ws = make_case(n=3000, seed=3, channels=3)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    for c in range(3):
        ref = oracle.direct_filter(x[c], ws.taps)
        assert oracle.max_lsb_error(y[c], ref, bits=24) <= high_tol_lsb24()


def test_extended_filter_equals_interior_of_same_filter():
    """Halo-extended filtering must equal the interior of full filtering —
    the property the sharded time-parallel path relies on (SURVEY.md §2.3).

    Different jit shapes can legally produce bit-different f32 roundings, so
    the check is at the quantization level, not bit equality.
    """
    x, ws = make_case(n=8000, seed=4)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    full = np.asarray(osv.same_filter(x, plan))
    mo2 = ws.mo2
    s, e = 2000, 6000
    xe = x[s - mo2 : e + mo2]
    seg = np.asarray(osv.extended_filter(xe, plan, e - s))
    assert oracle.max_lsb_error(seg, full[s:e], bits=24) <= 2 * high_tol_lsb24()


def test_kernel_longer_than_signal():
    x, ws = make_case(n=100, seed=5)  # M=200 > N=100
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x, ws.taps)
    assert oracle.max_lsb_error(y, ref, bits=24) <= high_tol_lsb24()


def test_impulse_through_engine_recovers_taps():
    ws = kd.WindowedSinc(0.1, 0.02).make_low_cut()
    n = ws.num_taps + 500
    x = np.zeros(n, dtype=np.float32)
    x[n // 2] = 1.0
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024)
    y = np.asarray(osv.same_filter(x, plan))
    lo = n // 2 - ws.mo2
    np.testing.assert_allclose(
        y[lo : lo + ws.num_taps], ws.taps.astype(np.float32), atol=2 ** -22
    )


def test_sine_passband_and_stopband():
    """Behavioral: a 20 Hz tone through a 440 Hz low-cut dies; 2 kHz passes."""
    fs = 44100.0
    ws = kd.WindowedSinc(440.0 / fs, 300.0 / fs).make_low_cut()
    n = 3 * ws.num_taps
    t = np.arange(n) / fs
    plan = osv.make_plan(ws.taps, precision=osv.FAST, block_size=2048)
    low = np.sin(2 * np.pi * 20.0 * t).astype(np.float32)
    hig = np.sin(2 * np.pi * 2000.0 * t).astype(np.float32)
    y_low = np.asarray(osv.same_filter(low, plan))[ws.num_taps : -ws.num_taps]
    y_hig = np.asarray(osv.same_filter(hig, plan))[ws.num_taps : -ws.num_taps]
    assert np.max(np.abs(y_low)) < 1e-3
    assert np.max(np.abs(y_hig - hig[ws.num_taps : -ws.num_taps])) < 1e-2


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_oracle(engine):
    """Every FFT engine implements identical semantics."""
    x, ws = make_case(n=6000, seed=9)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024, engine=engine)
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x, ws.taps)
    assert oracle.max_lsb_error(y, ref, bits=24) <= high_tol_lsb24(engine)


@pytest.mark.parametrize("precision,bits", [(osv.FAST, 16), (osv.HIGH, 24)])
def test_fft_engine_gate_multichannel_ragged(precision, bits):
    """The jnp.fft engine against the oracle over several blocks with a
    ragged tail, 2 channels. "high" is native float64, so its 1.0 LSB @
    24-bit gate holds on the CPU backend too."""
    x, ws = make_case(n=5 * 824 + 311, seed=21, channels=2)
    plan = osv.make_plan(ws.taps, precision=precision, block_size=1024,
                         engine="fft")
    y = np.asarray(osv.same_filter(x, plan))
    for c in range(2):
        ref = oracle.direct_filter(x[c], ws.taps)
        assert oracle.max_scaled_lsb_error(y[c], ref, bits=bits) <= 1.0


@pytest.mark.parametrize("precision,cdt", [(osv.FAST, np.complex64),
                                           (osv.HIGH, np.complex128)])
def test_fft_engine_x64_stays_scoped(precision, cdt):
    """High precision enables float64 only around the engine's own calls:
    H is complex128 (complex64 for fast), outputs are float32, and the
    process default dtype is float32 again after the call."""
    import jax
    import jax.numpy as jnp

    x, ws = make_case(n=3000, seed=22)
    plan = osv.make_plan(ws.taps, precision=precision, block_size=1024,
                         engine="fft")
    assert plan.H.dtype == cdt
    assert plan.H.shape == (1024 // 2 + 1,)
    y, peak = osv.same_filter_peak(x, plan)
    assert y.dtype == jnp.float32 and peak.dtype == jnp.float32
    assert not jax.config.jax_enable_x64
    assert jnp.zeros(3).dtype == jnp.float32
    assert jnp.asarray(1.0).dtype == jnp.float32


def test_fft_high_refuses_to_run_outside_x64_scope():
    """Without the scope a float64 cast silently yields float32; the
    engine raises instead of quietly running at float32."""
    x, ws = make_case(n=2000, seed=23)
    plan = osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024,
                         engine="fft")
    with pytest.raises(RuntimeError, match="x64_scope"):
        osv._same_filter_jit(np.asarray(x)[None], plan.static, plan.H)


@pytest.mark.parametrize("engine", ["pallas", "bogus"])
def test_make_plan_rejects_unknown_engines(engine):
    """The removed "pallas" kernel engine, or any unknown one, fails
    clearly rather than running anything in its place."""
    _, ws = make_case(n=10)
    with pytest.raises(ValueError, match="unknown engine"):
        osv.make_plan(ws.taps, precision=osv.HIGH, block_size=1024,
                      engine=engine)


def test_auto_engine_resolves_to_default():
    _, ws = make_case(n=10)
    plan = osv.make_plan(ws.taps, precision=osv.FAST, block_size=1024)
    assert plan.engine == osv.default_engine() in ENGINES
