"""Native C++ codec vs NumPy codec equivalence (bit-exact)."""

import numpy as np
import pytest

from lowcut.native import pcm_codec


@pytest.fixture(scope="module")
def native():
    n = pcm_codec.load()
    if n is None:
        pytest.skip("native codec unavailable (no g++?)")
    return n


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("be", [False, True])
def test_decode_matches_numpy(native, bits, be):
    from lowcut.audio import codec as pycodec

    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=3 * 4 * 1000, dtype=np.uint8)
    raw = raw[: (raw.size // (bits // 8)) * (bits // 8)]
    got = native.decode(raw, bits, be)
    if bits == 16:
        want = raw.view(">i2" if be else "<i2").astype(np.float32) / np.float32(32768)
    else:
        want = pycodec._unpack24(raw, be).astype(np.float32) * np.float32(1 / 8388608)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("be", [False, True])
def test_encode_matches_numpy(native, bits, be):
    from lowcut.audio import codec as pycodec

    rng = np.random.default_rng(1)
    x = rng.uniform(-1.2, 1.2, 5000).astype(np.float32)  # include clipping range
    # exact half-LSB values to exercise round-half-even
    x[:4] = np.array([0.5 / 32768, 1.5 / 32768, -0.5 / 32768, 2.5 / 32768])
    got = native.encode(x, bits, be)
    full = float(1 << (bits - 1))
    v = np.clip(np.rint(x.astype(np.float64) * full), -full, full - 1)
    if bits == 16:
        want = v.astype(">i2" if be else "<i2").tobytes()
    else:
        want = pycodec._pack24(v.astype(np.int32), be).tobytes()
    assert got == want


def test_peak(native):
    x = np.array([0.1, -0.9, 0.5], np.float32)
    assert native.peak(x) == np.float32(0.9)


def _numpy_decode_planar(raw, channels, bits, be):
    from lowcut.audio import codec as pycodec

    if bits == 16:
        flat = raw.view(">i2" if be else "<i2").astype(np.float32) / np.float32(32768)
    else:
        flat = pycodec._unpack24(raw, be).astype(np.float32) * np.float32(1 / 8388608)
    return np.ascontiguousarray(flat.reshape(-1, channels).T)


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_decode_planar_matches_numpy(native, bits, be, channels):
    rng = np.random.default_rng(2)
    frames = 997  # odd, exercises remainder handling
    raw = rng.integers(0, 256, size=frames * channels * (bits // 8),
                       dtype=np.uint8)
    got = native.decode_planar(raw, channels, bits, be)
    np.testing.assert_array_equal(got, _numpy_decode_planar(raw, channels, bits, be))


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_encode_planar_matches_numpy(native, bits, be, channels):
    from lowcut.audio import codec as pycodec

    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, (channels, 1009)).astype(np.float32)
    x[:, 0] = 0.5 / (1 << (bits - 1))  # round-half-even boundary
    got = native.encode_planar(x, bits, be)
    full = float(1 << (bits - 1))
    v = np.clip(np.rint(np.ascontiguousarray(x.T).reshape(-1).astype(np.float64)
                        * full), -full, full - 1)
    if bits == 16:
        want = v.astype(">i2" if be else "<i2").tobytes()
    else:
        want = pycodec._pack24(v.astype(np.int32), be).tobytes()
    assert got == want


def test_planar_threaded_matches_single(native):
    """The C++ thread fan-out must not change a single byte (disjoint
    ranges, same arithmetic) — determinism analog of the reference's
    range-split threading (ProcessFile.cp:60-83)."""
    rng = np.random.default_rng(4)
    frames = 1 << 18  # large enough that resolve_threads fans out
    x = rng.uniform(-1.0, 1.0, (2, frames)).astype(np.float32)
    single = native.encode_planar(x, 24, False, threads=1)
    multi = native.encode_planar(x, 24, False, threads=8)
    assert single == multi
    raw = np.frombuffer(multi, dtype=np.uint8)
    d1 = native.decode_planar(raw, 2, 24, False, threads=1)
    d8 = native.decode_planar(raw, 2, 24, False, threads=8)
    np.testing.assert_array_equal(d1, d8)


def test_codec_roundtrip_through_public_api():
    """decode/encode through audio.codec must round-trip quantized data
    bit-exactly whichever path (native or NumPy) is active."""
    from lowcut.audio import codec as pycodec
    from lowcut.audio.format import AudioFormat, Encoding

    rng = np.random.default_rng(5)
    fmt = AudioFormat(channels=2, sample_rate=48000.0, encoding=Encoding.PCM_24)
    pcm = rng.integers(-(1 << 23), 1 << 23, size=2 * 501, dtype=np.int64)
    data = pycodec._pack24(pcm.astype(np.int32), False).tobytes()
    planar = pycodec.decode(data, fmt)
    assert planar.shape == (2, 501)
    assert pycodec.encode(planar, fmt) == data
