"""CLI scenario/validation matrix tests (SURVEY.md §4.4, §2.4).

Replicates main.cp's behavior: exit codes, FileExists without -O, extension
mismatch, dir-with-extension error, batch mode, help text. Run in-process
(cli.main) for speed; one subprocess smoke test guards the real entry point.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lowcut import audio
from lowcut.audio import Encoding
from lowcut.audio.synth import create_audio_file
from lowcut.cli import main

FS = 8000.0
FAST = ["--precision", "fast", "--block-size", "1024", "-f", "100", "-s", "200"]


def wav(tmp_path, name, frames=3000, channels=1):
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.5, 0.5, (channels, frames)).astype(np.float32)
    p = tmp_path / name
    create_audio_file(p, x, FS, encoding=Encoding.PCM_16)
    return p


def test_single_file_success(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "b.wav"
    assert main([str(p), str(out), *FAST]) == 0
    assert out.exists()
    assert "Processing file: a.wav" in capsys.readouterr().out


def test_help_exits_zero(capsys):
    assert main(["--help"]) == 0
    text = capsys.readouterr().out
    assert "low-cut" in text and "lowcut" in text


def test_too_few_args_exit_1(capsys):
    assert main(["only_one_arg.wav"]) == 1
    assert "Invalid number of parameters" in capsys.readouterr().err


def test_missing_input_exit_1(tmp_path, capsys):
    assert main([str(tmp_path / "no.wav"), str(tmp_path / "o.wav")]) == 1
    assert "not found" in capsys.readouterr().err.lower()


def test_output_is_directory_error(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    d = tmp_path / "somedir"
    d.mkdir()
    assert main([str(p), str(d)]) == 1
    assert "must be a file path" in capsys.readouterr().err


def test_extension_mismatch_error(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    assert main([str(p), str(tmp_path / "b.aif")]) == 1
    assert "extensions must match" in capsys.readouterr().err


def test_file_exists_without_overwrite(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = wav(tmp_path, "b.wav")  # pre-existing
    before = out.read_bytes()
    assert main([str(p), str(out), *FAST]) == 1
    assert "exists" in capsys.readouterr().err.lower()
    assert out.read_bytes() == before  # untouched


def test_overwrite_flag(tmp_path):
    p = wav(tmp_path, "a.wav")
    out = wav(tmp_path, "b.wav")
    before = out.read_bytes()
    assert main([str(p), str(out), "-O", *FAST]) == 0
    assert out.read_bytes() != before


def test_batch_mode(tmp_path):
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    dest = tmp_path / "outdir"
    assert main([str(a), str(b), str(dest), *FAST]) == 0
    assert (dest / "a.wav").exists() and (dest / "b.wav").exists()


def test_batch_dest_with_extension_error(tmp_path, capsys):
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    assert main([str(a), str(b), str(tmp_path / "missing.wav")]) == 1
    assert "Undefined scenario" in capsys.readouterr().err


def test_batch_dest_exists_as_file_error(tmp_path, capsys):
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    f = wav(tmp_path, "f.wav")
    assert main([str(a), str(b), str(f)]) == 1
    assert "not a directory" in capsys.readouterr().err


def test_batch_collision_aborts_remaining_but_keeps_earlier(tmp_path):
    """main.cp:140-144: files processed before a FileExists collision stay."""
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    dest = tmp_path / "outdir"
    dest.mkdir()
    wav(dest, "b.wav")  # collision for the second input
    assert main([str(a), str(b), str(dest), *FAST]) == 1
    assert (dest / "a.wav").exists()  # first file was written before abort


def test_unknown_flag_exit_1(capsys):
    assert main(["--definitely-not-a-flag", "a.wav", "b.wav"]) == 1


def test_verbose_status(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "o.wav"
    assert main([str(p), str(out), "-v", *FAST]) == 0
    text = capsys.readouterr().out
    # Fixed inversion bug (SURVEY.md §2.4): status prints iff verbose.
    assert "Using" in text and "threads." in text
    assert "Filtering." in text


def test_not_verbose_no_status(tmp_path, capsys):
    p = wav(tmp_path, "a.wav")
    out = tmp_path / "o2.wav"
    assert main([str(p), str(out), *FAST]) == 0
    text = capsys.readouterr().out
    assert "Using" not in text
    assert "Processing file:" in text  # unconditional (ProcessFile.cp:37)


def test_subprocess_entry_point(tmp_path):
    """Real process: python -m lowcut --help (no device needed)."""
    r = subprocess.run(
        [sys.executable, "-m", "lowcut", "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert r.returncode == 0
    assert "lowcut" in r.stdout


def test_mesh_flag_cpu_8dev(tmp_path):
    """--mesh 1x8 drives the sharded path on the virtual CPU mesh."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    p = wav(tmp_path, "m.wav", frames=4000)
    out = tmp_path / "mo.wav"
    assert main([str(p), str(out), "--mesh", "1x8", *FAST]) == 0
    assert out.exists()
    ref_out = tmp_path / "ref.wav"
    assert main([str(p), str(ref_out), *FAST]) == 0
    a = audio.read_audio(out).samples
    b = audio.read_audio(ref_out).samples
    np.testing.assert_allclose(a, b, atol=4 / 32768)


def test_engine_pallas_rejected(tmp_path, capsys):
    """The removed "pallas" kernel engine: asking for it is a usage
    error, not a silent substitute."""
    p = wav(tmp_path, "e.wav")
    out = tmp_path / "eo.wav"
    assert main([str(p), str(out), "--engine", "pallas", *FAST]) == 1
    assert "pallas" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("engine", ["fft", "fourstep"])
def test_engine_flag_matches_default(tmp_path, engine):
    p = wav(tmp_path, "e.wav")
    out, ref_out = tmp_path / "eo.wav", tmp_path / "ref.wav"
    assert main([str(p), str(out), "--engine", engine, *FAST]) == 0
    assert main([str(p), str(ref_out), *FAST]) == 0
    np.testing.assert_allclose(audio.read_audio(out).samples,
                               audio.read_audio(ref_out).samples,
                               atol=1 / 32768)


def test_mesh_flag_bad_spec(tmp_path, capsys):
    p = wav(tmp_path, "m2.wav")
    assert main([str(p), str(tmp_path / "o.wav"), "--mesh", "banana"]) == 1
    assert "--mesh expects" in capsys.readouterr().err


def test_batch_resume_skips_completed(tmp_path, capsys):
    """--resume: manifest-marked files are skipped on re-run (SURVEY §5)."""
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    dest = tmp_path / "outdir"
    assert main([str(a), str(b), str(dest), "--resume", *FAST]) == 0
    mtime_a = (dest / "a.wav").stat().st_mtime_ns
    capsys.readouterr()
    assert main([str(a), str(b), str(dest), "--resume", "-v", *FAST]) == 0
    out = capsys.readouterr().out
    assert out.count("Skipping (already done)") == 2
    assert (dest / "a.wav").stat().st_mtime_ns == mtime_a  # untouched


def test_batch_resume_reprocesses_on_changed_options(tmp_path):
    a = wav(tmp_path, "a.wav")
    b = wav(tmp_path, "b.wav")
    dest = tmp_path / "outdir2"
    assert main([str(a), str(b), str(dest), "--resume", *FAST]) == 0
    mtime_a = (dest / "a.wav").stat().st_mtime_ns
    # different cutoff -> fingerprint mismatch -> reprocess
    args = [x for x in FAST]
    args[args.index("-f") + 1] = "150"
    assert main([str(a), str(b), str(dest), "--resume", *args]) == 0
    assert (dest / "a.wav").stat().st_mtime_ns != mtime_a


def test_filter_family_bandpass(tmp_path):
    from lowcut.ops import kernel_design as kd, oracle

    p = wav(tmp_path, "band.wav")
    out = tmp_path / "band_out.wav"
    assert main([str(p), str(out), "--filter", "bandpass", "-f", "300",
                 "-F", "1500", "-s", "400", "--precision", "fast",
                 "--block-size", "1024"]) == 0
    din, dout = audio.read_audio(p), audio.read_audio(out)
    taps = kd.bandpass_taps(300 / FS, 1500 / FS, kd.kernel_length(400 / FS))
    ref = oracle.direct_filter(din.samples[0].astype(np.float64), taps)
    assert oracle.max_lsb_error(dout.samples[0], ref, bits=16) <= 1.0


def test_band_filter_requires_high_edge(tmp_path, capsys):
    p = wav(tmp_path, "b1.wav")
    assert main([str(p), str(tmp_path / "o.wav"),
                 "--filter", "bandpass", *FAST]) == 1
    assert "--frequency-high" in capsys.readouterr().err


def test_band_edges_must_be_ordered(tmp_path, capsys):
    p = wav(tmp_path, "b2.wav")
    assert main([str(p), str(tmp_path / "o.wav"), "--filter", "bandreject",
                 "-f", "500", "-F", "100", *FAST[:4]]) == 1
    assert "must exceed" in capsys.readouterr().err


def test_high_edge_rejected_for_lowcut(tmp_path, capsys):
    p = wav(tmp_path, "b3.wav")
    assert main([str(p), str(tmp_path / "o.wav"), "-F", "500", *FAST]) == 1
    assert "only applies" in capsys.readouterr().err


def test_resume_fingerprint_includes_filter_type(tmp_path):
    """Resuming with a different --filter must reprocess, not skip."""
    p1, p2 = wav(tmp_path, "fp1.wav"), wav(tmp_path, "fp2.wav")
    dest = tmp_path / "out"
    base = [str(p1), str(p2), str(dest), "--resume", *FAST]
    assert main(base) == 0
    stamp = (dest / "fp1.wav").stat().st_mtime_ns
    # Same options: skipped (mtime unchanged).
    assert main(base) == 0
    assert (dest / "fp1.wav").stat().st_mtime_ns == stamp
    # Different filter family: reprocessed (mtime advances).
    assert main([*base, "--filter", "lowpass"]) == 0
    assert (dest / "fp1.wav").stat().st_mtime_ns != stamp
