"""Streamed (seek-walked, slab-overlapped) audio I/O vs the in-memory path.

The streamed read/write paths (audio/file.py: _read_audio_streamed,
_replace_sample_bytes_streamed) must be observably identical to the
in-memory paths: same decoded samples and format on read, byte-identical
output files on write — including unknown/odd-sized metadata chunks and
both container families. Thresholds are forced low so the tests exercise
the streaming machinery on small fixtures, with slab sizes shrunk so a
single file spans many slabs (the overlap/boundary logic)."""

import numpy as np
import pytest

from lowcut.audio import file as afile
from lowcut.audio.chunks import Chunk
from lowcut.audio.format import Encoding
from lowcut.audio.synth import create_audio_file

EXTRA = [Chunk(b"LIST", b"INFOsomething"), Chunk(b"odd ", b"xyz")]  # odd size


def _mk(tmp_path, name, kind_ext, encoding, channels=2, frames=5000):
    rng = np.random.default_rng(hash(name) % 2**31)
    x = rng.uniform(-0.9, 0.9, (channels, frames)).astype(np.float32)
    p = tmp_path / f"{name}.{kind_ext}"
    create_audio_file(p, x, 44100.0, encoding=encoding, extra_chunks=EXTRA)
    return p


CASES = [
    ("wav16", "wav", Encoding.PCM_16),
    ("wav24", "wav", Encoding.PCM_24),
    ("wavf32", "wav", Encoding.FLOAT_32),
    ("aiff16", "aif", Encoding.PCM_16),
    ("aiff24", "aif", Encoding.PCM_24),
]


@pytest.mark.parametrize("name,ext,enc", CASES)
def test_streamed_read_matches_in_memory(tmp_path, monkeypatch, name, ext, enc):
    monkeypatch.setattr(afile, "_SLAB_BYTES", 4096)  # many slabs per file
    p = _mk(tmp_path, name, ext, enc)
    mem = afile.read_audio(p)
    streamed = afile.read_audio(p, stream_threshold=0)
    assert streamed.fmt == mem.fmt
    np.testing.assert_array_equal(streamed.samples, mem.samples)
    assert [c.ckid for c in streamed.container.chunks] == [
        c.ckid for c in mem.container.chunks]
    # metadata chunks byte-exact (the data chunk is a placeholder by design)
    did = afile._DATA_CHUNK_ID[mem.kind]
    for cs, cm in zip(streamed.container.chunks, mem.container.chunks):
        if cs.ckid != did:
            assert cs.data == cm.data


@pytest.mark.parametrize("name,ext,enc", CASES)
def test_streamed_write_is_byte_identical(tmp_path, monkeypatch, name, ext, enc):
    p = _mk(tmp_path, name, ext, enc)
    data = afile.read_audio(p)
    y = (data.samples * np.float32(0.5)).astype(np.float32)

    out_mem = tmp_path / f"mem_{name}.{ext}"
    afile.write_audio(out_mem, data, samples=y)

    monkeypatch.setattr(afile, "_STREAM_MIN_BYTES", 0)
    monkeypatch.setattr(afile, "_SLAB_BYTES", 4096)
    out_str = tmp_path / f"str_{name}.{ext}"
    afile.write_audio(out_str, data, samples=y)

    assert out_str.read_bytes() == out_mem.read_bytes()


def test_streamed_roundtrip_via_streamed_read(tmp_path, monkeypatch):
    """Streamed read -> streamed write: the placeholder data chunk (SSND
    head only / empty for WAVE) must carry enough for the write path."""
    monkeypatch.setattr(afile, "_SLAB_BYTES", 4096)
    for name, ext, enc in (("rt_wav", "wav", Encoding.PCM_24),
                           ("rt_aiff", "aif", Encoding.PCM_16)):
        p = _mk(tmp_path, name, ext, enc)
        ref = afile.read_audio(p)
        data = afile.read_audio(p, stream_threshold=0)
        monkeypatch.setattr(afile, "_STREAM_MIN_BYTES", 0)
        out = tmp_path / f"out_{name}.{ext}"
        afile.write_audio(out, data, samples=data.samples)
        back = afile.read_audio(out)
        np.testing.assert_array_equal(back.samples, ref.samples)
        monkeypatch.setattr(afile, "_STREAM_MIN_BYTES", 64 << 20)


def test_streamed_read_odd_payload_and_truncation(tmp_path, monkeypatch):
    """Odd-sized 24-bit mono payload (pad byte) and a truncated final
    chunk both decode to the same samples as the in-memory reader."""
    monkeypatch.setattr(afile, "_SLAB_BYTES", 1024)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.9, 0.9, (1, 1001)).astype(np.float32)  # 3003 B: odd
    p = tmp_path / "odd.wav"
    create_audio_file(p, x, 8000.0, encoding=Encoding.PCM_24)
    mem = afile.read_audio(p)
    st = afile.read_audio(p, stream_threshold=0)
    np.testing.assert_array_equal(st.samples, mem.samples)

    # truncate mid-payload: both readers clamp identically
    raw = p.read_bytes()
    pt = tmp_path / "trunc.wav"
    pt.write_bytes(raw[:-100])
    mem = afile.read_audio(pt)
    st = afile.read_audio(pt, stream_threshold=0)
    np.testing.assert_array_equal(st.samples, mem.samples)
