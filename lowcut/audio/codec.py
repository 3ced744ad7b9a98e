"""PCM codec: container sample bytes <-> planar float32 arrays.

Host-side equivalent of the reference's c_lib ``AudioSamples``/``AudioBuffer``
(interface reconstructed in SURVEY.md §2.2 from
/root/reference/ProcessFile.cp:40-41,100,116-117): decode interleaved PCM of
the file's bit depth into per-channel (deinterleaved) float32 vectors scaled
so full scale is ±1.0, and encode back at the same bit depth.

Scaling convention (the clip test in the reference is ``maxMag > 1.0f``,
ProcessFile.cp:98, which implies decode divides by 2^(bits-1)):

    decode:  x = pcm / 2**(bits-1)          (u8: (pcm - 128) / 128)
    encode:  pcm = clip(rint(x * 2**(bits-1)), -2**(bits-1), 2**(bits-1)-1)

A native C++ fast path (``native/pcm_codec.cpp`` via ctypes) is used for the
hot 16/24-bit conversions when built; NumPy is the always-available fallback.
"""

from __future__ import annotations

import numpy as np

from .format import AudioFormat, Encoding
from ..utils.errors import AudioFormatError

# Optional native codec (C++). Loaded lazily; None means NumPy fallback.
_native = None
_native_checked = False


def _get_native():
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        try:
            from ..native import pcm_codec as _pc

            _native = _pc.load()
        except Exception:
            _native = None
    return _native


def codec_name() -> str:
    """Which PCM codec runs the 16/24-bit conversions: "native" or
    "numpy"."""
    return "native" if _get_native() is not None else "numpy"


def _unpack24(data: np.ndarray, big_endian: bool) -> np.ndarray:
    """24-bit packed bytes [3n] (uint8) -> int32 [n], sign-extended."""
    b = data.reshape(-1, 3).astype(np.int32)
    if big_endian:
        val = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
    else:
        val = (b[:, 2] << 16) | (b[:, 1] << 8) | b[:, 0]
    return (val ^ 0x800000) - 0x800000  # sign-extend from bit 23


def _pack24(vals: np.ndarray, big_endian: bool) -> np.ndarray:
    """int32 [n] -> 24-bit packed uint8 [3n]."""
    v = vals.astype(np.int32)
    out = np.empty((v.size, 3), dtype=np.uint8)
    lo, mid, hi = v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF
    if big_endian:
        out[:, 0], out[:, 1], out[:, 2] = hi, mid, lo
    else:
        out[:, 0], out[:, 1], out[:, 2] = lo, mid, hi
    return out.reshape(-1)


def decode(data: bytes, fmt: AudioFormat) -> np.ndarray:
    """Decode interleaved sample bytes -> planar float32 [channels, frames]."""
    enc = fmt.encoding
    ch = fmt.channels
    bps = enc.bytes_per_sample
    usable = (len(data) // (bps * ch)) * bps * ch
    raw = np.frombuffer(data, dtype=np.uint8, count=usable)
    be = fmt.big_endian_samples

    native = _get_native()
    if native is not None and enc in (Encoding.PCM_16, Encoding.PCM_24):
        # Fused codec + deinterleave, one pass (C++, threaded, GIL released).
        return native.decode_planar(raw, ch, enc.bits, be)
    if enc == Encoding.PCM_16:
        dt = ">i2" if be else "<i2"
        flat = raw.view(dt).astype(np.float32) * np.float32(1.0 / 32768.0)
    elif enc == Encoding.PCM_24:
        flat = _unpack24(raw, be).astype(np.float32) * np.float32(1.0 / 8388608.0)
    elif enc == Encoding.PCM_32:
        dt = ">i4" if be else "<i4"
        flat = (raw.view(dt).astype(np.float64) / 2147483648.0).astype(np.float32)
    elif enc == Encoding.PCM_U8:
        flat = (raw.astype(np.float32) - 128.0) * np.float32(1.0 / 128.0)
    elif enc == Encoding.PCM_S8:
        flat = raw.view(np.int8).astype(np.float32) * np.float32(1.0 / 128.0)
    elif enc == Encoding.FLOAT_32:
        dt = ">f4" if be else "<f4"
        flat = raw.view(dt).astype(np.float32)
    elif enc == Encoding.FLOAT_64:
        dt = ">f8" if be else "<f8"
        flat = raw.view(dt).astype(np.float32)
    else:  # pragma: no cover
        raise AudioFormatError(f"Unsupported encoding: {enc}")

    frames = flat.size // ch
    # Deinterleave: interleaved [frames*ch] -> planar [ch, frames].
    return np.ascontiguousarray(flat.reshape(frames, ch).T)


def encode(samples: np.ndarray, fmt: AudioFormat) -> bytes:
    """Encode planar float32 [channels, frames] -> interleaved sample bytes."""
    enc = fmt.encoding
    if samples.ndim != 2:
        raise AudioFormatError("samples must be [channels, frames]")
    be = fmt.big_endian_samples

    native = _get_native()
    if native is not None and enc in (Encoding.PCM_16, Encoding.PCM_24):
        # Fused interleave + quantize, one pass (C++, threaded, GIL released).
        return native.encode_planar(
            np.asarray(samples, dtype=np.float32), enc.bits, be)

    interleaved = np.ascontiguousarray(samples.T).reshape(-1)

    if enc in (Encoding.PCM_16, Encoding.PCM_24, Encoding.PCM_32, Encoding.PCM_S8):
        full = float(1 << (enc.bits - 1))
        v = np.clip(
            np.rint(interleaved.astype(np.float64) * full), -full, full - 1
        )
        if enc == Encoding.PCM_16:
            return v.astype(">i2" if be else "<i2").tobytes()
        if enc == Encoding.PCM_24:
            return _pack24(v.astype(np.int32), be).tobytes()
        if enc == Encoding.PCM_32:
            return v.astype(">i4" if be else "<i4").tobytes()
        return v.astype(np.int8).tobytes()
    if enc == Encoding.PCM_U8:
        v = np.clip(np.rint(interleaved.astype(np.float64) * 128.0) + 128.0, 0, 255)
        return v.astype(np.uint8).tobytes()
    if enc == Encoding.FLOAT_32:
        return interleaved.astype(">f4" if be else "<f4").tobytes()
    if enc == Encoding.FLOAT_64:
        return interleaved.astype(np.float64).astype(">f8" if be else "<f8").tobytes()
    raise AudioFormatError(f"Unsupported encoding: {enc}")  # pragma: no cover
