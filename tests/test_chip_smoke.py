"""chip_smoke.py must never report a result it did not get on a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    r = _run(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "checkout" in r.stderr


# Each phase of the script at tiny sizes on the CPU: what the card run
# does, minus the card.

def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_engines_phase_tiny():
    cs = _smoke()
    cs.phase_engines(cs.Sizes(rehearsal=True), ("fft", "fourstep"), 1)


def test_cli_phase_tiny(tmp_path):
    import jax

    cs = _smoke()
    d = jax.devices()[0]
    cs.phase_cli(cs.Sizes(rehearsal=True), tmp_path,
                 {"platform": d.platform, "kind": d.device_kind, "count": 1})


def test_four_phase_tiny(tmp_path):
    import jax
    import pytest

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    cs = _smoke()
    cs.phase_four(cs.Sizes(rehearsal=True), tmp_path)


def test_cli_phase_catches_a_wrong_filter(tmp_path, monkeypatch):
    """The oracle windows fail a run whose output is off by a few LSB at
    24-bit, though it exits 0 and keeps its chunks."""
    import jax
    import numpy as np
    import pytest

    import importlib

    pf = importlib.import_module("lowcut.pipeline.process_file")
    real = pf.filter_array_streamed

    def off(x, plan, **kw):
        y, peak = real(x, plan, **kw)
        return y * np.float32(1 + 2.0 ** -19), peak

    monkeypatch.setattr(pf, "filter_array_streamed", off)
    cs = _smoke()
    d = jax.devices()[0]
    with pytest.raises(cs.Failed, match="LSB @ 24-bit"):
        cs.phase_cli(cs.Sizes(rehearsal=True), tmp_path,
                     {"platform": d.platform, "kind": d.device_kind,
                      "count": 1})
