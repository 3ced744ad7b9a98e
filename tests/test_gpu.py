"""Tests that need an NVIDIA GPU (marker ``gpu``); they skip elsewhere.

Run them on the card (chip_smoke.py does)::

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu

They cover what only the card can show: the fft engine lowering to the
GPU's FFT at float64, the double-float engines' error-free arithmetic
surviving the GPU compiler (which may contract a multiply and an add into
an FMA), and the file pipeline reporting the GPU that filtered.
"""

import jax
import numpy as np
import pytest

import test_df64
from lowcut.ops import kernel_design as kd
from lowcut.ops import oracle
from lowcut.ops import overlap_save as osv
from lowcut.utils.options import ENGINES

pytestmark = pytest.mark.gpu


def _case(n=6000, seed=0):
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()   # 201 taps
    x = np.random.default_rng(seed).uniform(-1, 1, (2, n)).astype(np.float32)
    return x, ws.taps


def test_default_device_is_gpu():
    d = jax.devices()[0]
    assert d.platform == "gpu", d


@pytest.mark.parametrize("precision,dtype", [(osv.HIGH, "f64"),
                                             (osv.FAST, "f32")])
def test_fft_engine_compiles_to_device_fft(precision, dtype):
    """The compiled program holds XLA's FFT op (cuFFT) at the precision's
    float width."""
    x, taps = _case()
    plan = osv.make_plan(taps, precision=precision, block_size=1024,
                         engine="fft")
    with osv.x64_scope(plan.static):
        text = osv._same_filter_jit.lower(
            x, plan.static, plan.H).compile().as_text()
    assert "fft_type=RFFT" in text and "fft_type=IRFFT" in text
    assert f"{dtype}[" in text


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("precision,bits", [(osv.HIGH, 24), (osv.FAST, 16)])
def test_engines_meet_gate_on_card(engine, precision, bits):
    """Every engine at the strict gate on the card: <= 1 LSB @ 24-bit for
    high (no CPU relaxation here), <= 1 LSB @ 16-bit for fast."""
    x, taps = _case(seed=1)
    plan = osv.make_plan(taps, precision=precision, block_size=1024,
                         engine=engine)
    y = np.asarray(osv.same_filter(x, plan))
    for c in range(2):
        ref = oracle.direct_filter(x[c], taps)
        assert oracle.max_scaled_lsb_error(y[c], ref, bits=bits) <= 1.0


@pytest.mark.parametrize("check", [
    test_df64.test_two_sum_error_free_under_jit,
    test_df64.test_two_prod_error_free_under_jit,
    test_df64.test_cmul_accuracy,
], ids=lambda f: f.__name__)
def test_error_free_transforms_on_card(check):
    """The double-float building blocks stay error-free as the GPU
    compiler builds them."""
    check()


def test_process_file_reports_gpu(tmp_path):
    from lowcut.audio import Encoding
    from lowcut.audio.synth import create_audio_file
    from lowcut.pipeline import process_file
    from lowcut.utils.options import FilterOptions

    x, _ = _case(n=8000)
    p = tmp_path / "in.wav"
    create_audio_file(p, 0.5 * x, 8000.0, encoding=Encoding.PCM_24)
    m = process_file(p, tmp_path / "out.wav",
                     FilterOptions(freq=100.0, slope=200.0, block_size=1024),
                     show_progress=False)
    assert m["device"]["platform"] == "gpu"
    assert m["device"]["kind"] == jax.devices()[0].device_kind
