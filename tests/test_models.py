"""Filter model families (models/fir.py).

The reference ships exactly one filter (low-cut); the framework exposes the
whole windowed-sinc family built from the same primitives. Each family is
validated end-to-end: spec in Hz -> taps at a sample rate -> device
overlap-save plan -> output matches the float64 oracle.
"""

import numpy as np
import pytest

from lowcut.models import BandPass, BandReject, HighPass, LowCut, LowPass
from lowcut.ops import oracle
from lowcut.ops import overlap_save as osv

FS = 8000.0


def _run(model, x):
    plan = model.plan(FS, precision=osv.HIGH, block_size=1024,
                      engine="fourstep")
    y = np.asarray(osv.same_filter(x, plan))
    ref = oracle.direct_filter(x.astype(np.float64), model.taps(FS))
    assert oracle.max_lsb_error(y, ref, bits=24) <= 1.0
    return y


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(7)
    return (0.4 * rng.standard_normal(6000)).astype(np.float32)


def test_lowcut_matches_oracle(x):
    _run(LowCut(freq=100.0, slope=400.0), x)


def test_highpass_is_lowcut_alias(x):
    hp, lc = HighPass(freq=100.0, slope=400.0), LowCut(freq=100.0, slope=400.0)
    np.testing.assert_array_equal(hp.taps(FS), lc.taps(FS))


def test_lowpass_matches_oracle(x):
    _run(LowPass(freq=1000.0, slope=400.0), x)


def test_bandpass_matches_oracle(x):
    _run(BandPass(f_lo=300.0, f_hi=1500.0, slope=400.0), x)


def test_bandreject_matches_oracle(x):
    _run(BandReject(f_lo=300.0, f_hi=1500.0, slope=400.0), x)


def test_frequency_response_shapes():
    """Passband/stopband gains of each family at its design rate."""
    m = 400  # generous order so transition bands are steep

    def gain_at(taps, f_norm):
        n = np.arange(len(taps))
        return abs(np.sum(taps * np.exp(-2j * np.pi * f_norm * n)))

    lp = LowPass(freq=1000.0, slope=FS / m * 4)
    t = lp.taps(FS)
    assert gain_at(t, 100 / FS) == pytest.approx(1.0, abs=1e-3)
    assert gain_at(t, 3500 / FS) < 1e-3

    bp = BandPass(f_lo=500.0, f_hi=1500.0, slope=FS / m * 4)
    t = bp.taps(FS)
    assert gain_at(t, 1000 / FS) == pytest.approx(1.0, abs=1e-2)
    assert gain_at(t, 50 / FS) < 1e-2
    assert gain_at(t, 3500 / FS) < 1e-2

    br = BandReject(f_lo=500.0, f_hi=1500.0, slope=FS / m * 4)
    t = br.taps(FS)
    assert gain_at(t, 1000 / FS) < 1e-2
    assert gain_at(t, 50 / FS) == pytest.approx(1.0, abs=1e-2)
    assert gain_at(t, 3500 / FS) == pytest.approx(1.0, abs=1e-2)


def test_plan_is_cached():
    m = LowCut(freq=100.0, slope=400.0)
    assert m.plan(FS, block_size=1024) is m.plan(FS, block_size=1024)
    assert m.plan(FS, block_size=1024) is not m.plan(FS, block_size=2048)


def test_invalid_sample_rate():
    with pytest.raises(ValueError):
        LowCut().taps(0.0)
