"""Compile-cache placement (utils/jax_setup.py): JAX_COMPILATION_CACHE_DIR
wins when set; otherwise the cache sits at a fixed path in the checkout."""

import os
import subprocess
import sys
from pathlib import Path

from lowcut.utils import jax_setup

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import jax, jax.numpy as jnp
import lowcut.ops.overlap_save  # configures JAX on import
jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env):
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_env_cache_dir_receives_the_cache(tmp_path):
    cache = tmp_path / "cc"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    assert _probe(env) == str(cache)
    assert any(cache.iterdir())


def test_cache_defaults_to_checkout_dir():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _probe(env) == str(ROOT / ".jax_cache")


def test_cache_dir_rule(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert jax_setup.compilation_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert jax_setup.compilation_cache_dir() == str(ROOT / ".jax_cache")
