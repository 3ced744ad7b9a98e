"""Pipelined batch runner (pipeline/batch.py).

The -t host worker pool: reads prefetch ahead of the device, writes land in
the background. These tests pin the semantics the pipeline must preserve
from the reference's serial loop (/root/reference/main.cp:132-147):
argument-order processing, per-file validation at that file's turn,
earlier files staying written after an abort — plus output equivalence
with the single-file path.
"""

import numpy as np
import pytest

from lowcut import audio
from lowcut.audio import Encoding
from lowcut.audio.synth import create_audio_file
from lowcut.pipeline import process_file
from lowcut.pipeline.batch import run_batch
from lowcut.utils.errors import FileExists, FileNotFound
from lowcut.utils.options import FilterOptions

FS = 8000.0


def opts(**kw):
    base = dict(freq=100.0, slope=200.0, precision="fast", block_size=1024,
                num_threads=3)
    base.update(kw)
    return FilterOptions(**base)


def wav(path, frames=3000, channels=1, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, (channels, frames)).astype(np.float32)
    create_audio_file(path, x, FS, encoding=Encoding.PCM_16)
    return path


def test_outputs_match_single_file_path(tmp_path):
    ins = [wav(tmp_path / f"f{i}.wav", frames=2000 + 700 * i, seed=i)
           for i in range(4)]
    dest = tmp_path / "batch_out"
    dest.mkdir()
    run_batch(ins, dest, opts(), overwrite=False)

    serial = tmp_path / "serial_out"
    serial.mkdir()
    for p in ins:
        process_file(p, serial / p.name, opts(), show_progress=False)
    for p in ins:
        a = audio.read_audio(dest / p.name)
        b = audio.read_audio(serial / p.name)
        np.testing.assert_array_equal(a.samples, b.samples)


def test_metrics_emitted_per_file_in_order(tmp_path):
    ins = [wav(tmp_path / f"m{i}.wav", seed=i) for i in range(5)]
    dest = tmp_path / "out"
    dest.mkdir()
    seen = []
    run_batch(ins, dest, opts(), metrics_cb=lambda m, d: seen.append((m, d)))
    # Writes may land out of order across 2 writer threads, but every file
    # reports exactly once with a complete metrics dict.
    assert sorted(d.name for _, d in seen) == sorted(p.name for p in ins)
    for m, _ in seen:
        for key in ("read", "design", "filter", "normalize", "write",
                    "frames", "channels", "sample_rate", "peak"):
            assert key in m


def test_collision_aborts_after_earlier_files_written(tmp_path):
    ins = [wav(tmp_path / f"c{i}.wav", seed=i) for i in range(3)]
    dest = tmp_path / "out"
    dest.mkdir()
    (dest / ins[1].name).write_bytes(b"occupied")  # collide on file #2
    with pytest.raises(FileExists):
        run_batch(ins, dest, opts(), overwrite=False)
    assert (dest / ins[0].name).exists()
    assert (dest / ins[1].name).read_bytes() == b"occupied"
    assert not (dest / ins[2].name).exists()


def test_missing_input_aborts_at_its_turn(tmp_path):
    first = wav(tmp_path / "ok.wav")
    dest = tmp_path / "out"
    dest.mkdir()
    with pytest.raises(FileNotFound):
        run_batch([first, tmp_path / "missing.wav"], dest, opts())
    assert (dest / "ok.wav").exists()


def test_duplicate_filenames_last_wins_with_overwrite(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    d1.mkdir(), d2.mkdir()
    p1 = wav(d1 / "same.wav", seed=1)
    p2 = wav(d2 / "same.wav", seed=2)
    dest = tmp_path / "out"
    dest.mkdir()
    run_batch([p1, p2], dest, opts(), overwrite=True)
    got = audio.read_audio(dest / "same.wav")
    want = tmp_path / "want.wav"
    process_file(p2, want, opts(), show_progress=False)
    np.testing.assert_array_equal(got.samples,
                                  audio.read_audio(want).samples)


def test_manifest_skip_and_mark(tmp_path):
    from lowcut.pipeline.manifest import (
        BatchManifest, options_fingerprint)

    ins = [wav(tmp_path / f"r{i}.wav", seed=i) for i in range(3)]
    dest = tmp_path / "out"
    dest.mkdir()
    o = opts()
    man = BatchManifest(dest, options_fingerprint(o))
    run_batch(ins, dest, o, manifest=man)
    assert all(man.is_done(p) for p in ins)

    # Second run skips everything: outputs untouched (compare mtimes).
    stamps = {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}
    man2 = BatchManifest(dest, options_fingerprint(o))
    run_batch(ins, dest, o, manifest=man2)
    assert stamps == {p.name: (dest / p.name).stat().st_mtime_ns for p in ins}


def test_shared_plan_cache_across_batch(tmp_path):
    """Files at one sample rate share one designed kernel (design ~ once)."""
    ins = [wav(tmp_path / f"s{i}.wav", seed=i) for i in range(4)]
    dest = tmp_path / "out"
    dest.mkdir()
    seen = []
    run_batch(ins, dest, opts(), metrics_cb=lambda m, d: seen.append(m))
    designs = sorted(m["design"] for m in seen)
    # First file pays the design; the rest hit the cache (>=10x cheaper or
    # sub-millisecond).
    assert designs[-2] < max(designs[-1] / 10, 1e-3)


def test_manifest_engine_flip_not_skipped(tmp_path):
    """Engines round float32 differently; a resume that flips --engine must
    reprocess, not skip (manifest fingerprint includes engine)."""
    from lowcut.pipeline.manifest import (
        BatchManifest, options_fingerprint)

    ins = [wav(tmp_path / "e0.wav", seed=3)]
    dest = tmp_path / "out"
    dest.mkdir()
    o1 = opts(engine="fourstep")
    man = BatchManifest(dest, options_fingerprint(o1))
    run_batch(ins, dest, o1, manifest=man)
    stamp = (dest / "e0.wav").stat().st_mtime_ns

    o2 = opts(engine="pease", overwrite=True) if hasattr(o1, "overwrite") \
        else opts(engine="pease")
    assert options_fingerprint(o1) != options_fingerprint(o2)
    man2 = BatchManifest(dest, options_fingerprint(o2))
    assert not man2.is_done(str(ins[0]))  # fingerprint mismatch: fresh state
