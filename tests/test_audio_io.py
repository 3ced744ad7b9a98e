"""Audio container + codec tests (SURVEY.md §4.2).

Covers: byte-exact container round-trip with odd-sized and unknown chunks,
codec encode/decode inverses at 16/24/32-bit and float, WAVE<->AIFF
endianness, ext80 sample-rate codec, normalize semantics.
"""

import struct

import numpy as np
import pytest

from lowcut.audio import (
    AudioFormat,
    Chunk,
    Encoding,
    normalize,
    parse_container,
    read_audio,
    serialize_container,
    write_audio,
)
from lowcut.audio import codec
from lowcut.audio.chunks import AIFF, WAVE
from lowcut.audio.format import _decode_ext80, _encode_ext80
from lowcut.audio.synth import build_container, create_audio_file, make_format
from lowcut.utils.errors import AudioFormatError, FileNotFound


def rng():
    return np.random.default_rng(1234)


def random_samples(channels=2, frames=1000, scale=0.9):
    return (rng().uniform(-scale, scale, (channels, frames))).astype(np.float32)


# ---------------------------------------------------------------- containers

def test_container_roundtrip_byte_exact_wave():
    x = random_samples()
    c = build_container(x, 44100, WAVE, Encoding.PCM_16)
    blob = serialize_container(c)
    c2 = parse_container(blob)
    assert serialize_container(c2) == blob
    assert [ck.ckid for ck in c2.chunks] == [b"fmt ", b"data"]


def test_container_roundtrip_odd_and_unknown_chunks():
    x = random_samples(1, 11)
    odd = Chunk(b"JUNK", b"\x01\x02\x03")       # odd size -> pad byte
    unknown = Chunk(b"uXyZ", bytes(range(16)))
    c = build_container(x, 48000, WAVE, Encoding.PCM_24, extra_chunks=[odd, unknown])
    blob = serialize_container(c)
    c2 = parse_container(blob)
    assert [ck.ckid for ck in c2.chunks] == [b"fmt ", b"JUNK", b"uXyZ", b"data"]
    assert c2.find(b"JUNK").data == b"\x01\x02\x03"
    assert c2.find(b"uXyZ").data == bytes(range(16))
    assert serialize_container(c2) == blob


def test_container_rejects_garbage():
    with pytest.raises(AudioFormatError):
        parse_container(b"NOTATHING" + b"\x00" * 100)
    with pytest.raises(AudioFormatError):
        parse_container(b"RIFF\x00\x00\x00\x00XXXX")


# ---------------------------------------------------------------- ext80

@pytest.mark.parametrize("rate", [8000.0, 22050.0, 44100.0, 48000.0, 96000.0, 192000.0])
def test_ext80_roundtrip(rate):
    assert _decode_ext80(_encode_ext80(rate)) == rate


def test_ext80_known_bytes_44100():
    # Canonical AIFF 44100 Hz: 400E AC44 0000 0000 0000
    assert _encode_ext80(44100.0) == bytes.fromhex("400eac44000000000000")
    assert _decode_ext80(bytes.fromhex("400eac44000000000000")) == 44100.0


# ---------------------------------------------------------------- codec

@pytest.mark.parametrize("enc", [
    Encoding.PCM_16, Encoding.PCM_24, Encoding.PCM_32,
    Encoding.FLOAT_32, Encoding.PCM_U8,
])
def test_codec_roundtrip_wave(enc):
    x = random_samples(2, 777)
    fmt = make_format(WAVE, 2, 44100, enc)
    decoded = codec.decode(codec.encode(x, fmt), fmt)
    assert decoded.shape == x.shape
    tol = {Encoding.PCM_16: 2 ** -16, Encoding.PCM_24: 2 ** -24,
           Encoding.PCM_32: 2 ** -23, Encoding.FLOAT_32: 0,
           Encoding.PCM_U8: 2 ** -8}[enc]
    assert np.max(np.abs(decoded - x)) <= tol + 1e-9


@pytest.mark.parametrize("enc", [Encoding.PCM_16, Encoding.PCM_24, Encoding.PCM_S8])
def test_codec_roundtrip_aiff_big_endian(enc):
    x = random_samples(2, 333)
    fmt = make_format(AIFF, 2, 48000, enc)
    decoded = codec.decode(codec.encode(x, fmt), fmt)
    tol = 2.0 ** -(enc.bits)
    assert np.max(np.abs(decoded - x)) <= tol * 2


def test_codec_int_values_exact_16():
    """PCM decode divides by 2^(bits-1); encode is its exact inverse."""
    fmt = make_format(WAVE, 1, 44100, Encoding.PCM_16)
    ints = np.array([-32768, -1, 0, 1, 32767], dtype="<i2")
    x = codec.decode(ints.tobytes(), fmt)
    np.testing.assert_allclose(x[0], ints.astype(np.float64) / 32768.0, rtol=0, atol=0)
    back = np.frombuffer(codec.encode(x, fmt), dtype="<i2")
    np.testing.assert_array_equal(back, ints)


def test_codec_24bit_sign_extension():
    fmt = make_format(WAVE, 1, 44100, Encoding.PCM_24)
    # -1 as 24-bit LE is FF FF FF; -2^23 is 00 00 80
    data = bytes.fromhex("ffffff") + bytes.fromhex("000080")
    x = codec.decode(data, fmt)
    np.testing.assert_allclose(x[0], [-1.0 / 8388608.0, -1.0], atol=0)
    assert codec.encode(x, fmt) == data


def test_codec_clipping_on_encode():
    fmt = make_format(WAVE, 1, 44100, Encoding.PCM_16)
    x = np.array([[1.5, -1.5, 1.0]], dtype=np.float32)
    back = np.frombuffer(codec.encode(x, fmt), dtype="<i2")
    np.testing.assert_array_equal(back, [32767, -32768, 32767])


# ---------------------------------------------------------------- file API

@pytest.mark.parametrize("ext,enc", [
    (".wav", Encoding.PCM_16), (".wav", Encoding.PCM_24),
    (".wav", Encoding.FLOAT_32),
    (".aif", Encoding.PCM_16), (".aif", Encoding.PCM_24),
])
def test_file_roundtrip(tmp_path, ext, enc):
    x = random_samples(2, 500)
    p = tmp_path / f"t{ext}"
    create_audio_file(p, x, 44100, encoding=enc)
    data = read_audio(p)
    assert data.fmt.sample_rate == 44100
    assert data.num_channels == 2 and data.num_frames == 500
    tol = 2.0 ** -(enc.bits) if enc != Encoding.FLOAT_32 else 0
    assert np.max(np.abs(data.samples - x)) <= tol + 1e-9


def test_write_preserves_unknown_chunks_byte_exact(tmp_path):
    x = random_samples(1, 100)
    meta = Chunk(b"bext", b"some broadcast metadata\x00!")
    p = tmp_path / "in.wav"
    create_audio_file(p, x, 44100, encoding=Encoding.PCM_24, extra_chunks=[meta])
    data = read_audio(p)
    out = tmp_path / "out.wav"
    write_audio(out, data, samples=data.samples * np.float32(0.5))
    data2 = read_audio(out)
    assert [c.ckid for c in data2.container.chunks] == [c.ckid for c in data.container.chunks]
    assert data2.container.find(b"bext").data == meta.data
    assert np.max(np.abs(data2.samples - data.samples * 0.5)) <= 2 ** -24 + 1e-9


def test_aiff_ssnd_offset_respected(tmp_path):
    """SSND offset/blockSize header and lead-in bytes must survive rewrite."""
    x = random_samples(1, 50)
    c = build_container(x, 44100, AIFF, Encoding.PCM_16)
    # Inject a 4-byte SSND offset with sentinel lead-in bytes.
    idx = c.find_index(b"SSND")
    payload = c.chunks[idx].data[8:]
    c.chunks[idx] = Chunk(b"SSND", struct.pack(">II", 4, 0) + b"\xde\xad\xbe\xef" + payload)
    p = tmp_path / "t.aif"
    p.write_bytes(serialize_container(c))
    data = read_audio(p)
    assert data.num_frames == 50
    np.testing.assert_allclose(data.samples, codec.decode(payload, data.fmt), atol=2 ** -15)
    out = tmp_path / "o.aif"
    write_audio(out, data)
    raw = parse_container(out.read_bytes())
    assert raw.find(b"SSND").data[:12] == struct.pack(">II", 4, 0) + b"\xde\xad\xbe\xef"


def test_read_missing_file_raises():
    with pytest.raises(FileNotFound):
        read_audio("/nonexistent/nope.wav")


# ---------------------------------------------------------------- normalize

def test_normalize_common_factor_across_channels():
    x = np.array([[0.5, -0.25], [0.1, 0.2]], dtype=np.float32)
    y = normalize(x)
    assert np.isclose(np.max(np.abs(y)), 1.0)
    # One common factor: channel ratios preserved.
    np.testing.assert_allclose(y, x / 0.5, rtol=1e-6)


def test_normalize_silence_is_noop():
    x = np.zeros((2, 10), dtype=np.float32)
    np.testing.assert_array_equal(normalize(x), x)


# ------------------------------------------------------------- size limits

def test_write_rejects_over_4gb_chunk():
    """A >4 GB data chunk must fail typed and EARLY (before any payload
    serialization), not as a raw struct.error mid-write — RIFF/IFF sizes
    are u32 (audio/chunks.py write_container guard)."""
    import io

    from lowcut.audio.chunks import Chunk, Container, StreamedChunk

    class _Giant(StreamedChunk):
        def __init__(self):
            super().__init__(b"data", 5 * 1024**3,
                             lambda f: (_ for _ in ()).throw(
                                 AssertionError("payload must not be written")))

    c = Container(kind=WAVE, form_type=b"WAVE",
                  chunks=[Chunk(b"fmt ", b"\x00" * 16), _Giant()])
    buf = io.BytesIO()
    from lowcut.audio.chunks import write_container
    with pytest.raises(AudioFormatError, match="4 GB"):
        write_container(buf, c)
    assert buf.getvalue() == b""  # nothing written, not even the header


def test_write_rejects_over_4gb_total():
    """Total form payload just over u32 also fails typed (many chunks,
    each individually legal)."""
    import io

    from lowcut.audio.chunks import Container, StreamedChunk, write_container

    big = StreamedChunk(b"data", 0xFFFFFFF0, lambda f: None)
    tip = StreamedChunk(b"more", 64, lambda f: None)
    c = Container(kind=WAVE, form_type=b"WAVE", chunks=[big, tip])
    with pytest.raises(AudioFormatError, match="4 GB"):
        write_container(io.BytesIO(), c)
