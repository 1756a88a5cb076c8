"""Dependency-free WAV I/O (counterpart of `salsa_tpu.utils.audio_io`): PCM
8/16/24/32-bit and IEEE float 32/64, `WAVE_FORMAT_EXTENSIBLE` included, and
polyphase resampling through scipy.

Values are normalized to float32 in [-1, 1) as libsndfile does (divide by
2^(bits-1)). `salsa_tpu`'s C++ fast path (`salsa_tpu/native/wavio.cpp`) is not
ported: `read_wav` is its pure-Python reader.
"""
from __future__ import annotations

import struct
from math import gcd

import numpy as np


def resample(audio: np.ndarray, orig_fs: int, target_fs: int) -> np.ndarray:
    """Polyphase (kaiser-windowed FIR) resampling along the last axis, by the
    rational factor target/orig reduced by gcd (scipy.signal.resample_poly)."""
    if orig_fs == target_fs:
        return audio
    from scipy.signal import resample_poly

    g = gcd(int(orig_fs), int(target_fs))
    out = resample_poly(audio.astype(np.float64), int(target_fs) // g,
                        int(orig_fs) // g, axis=-1)
    return out.astype(np.float32)


def _chunks(f, path: str, want_data: bool):
    """Walk the RIFF chunks of an open WAV: (fmt bytes, data bytes or data size)."""
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = data = None
    while fmt is None or data is None:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        chunk_id, chunk_size = struct.unpack("<4sI", hdr)
        if chunk_id == b"fmt ":
            fmt = f.read(chunk_size)
            f.seek(chunk_size % 2, 1)
        elif chunk_id == b"data" and want_data:
            data = f.read(chunk_size)
            f.seek(chunk_size % 2, 1)
        else:
            if chunk_id == b"data":
                data = chunk_size
            f.seek(chunk_size + (chunk_size % 2), 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data


def wav_info(path: str) -> tuple[int, int, int]:
    """Header-only WAV probe: (n_channels, n_samples, fs) without decoding."""
    with open(path, "rb") as f:
        fmt, data_size = _chunks(f, path, want_data=False)
    _fmt, n_channels, fs, _rate, block_align, _bits = struct.unpack("<HHIIHH", fmt[:16])
    return n_channels, data_size // block_align, fs


def resampled_length(n_samples: int, orig_fs: int, target_fs: int) -> int:
    """Output length of `resample(audio, orig_fs, target_fs)` along the last axis
    (scipy.signal.resample_poly: ceil(n * up / down) after gcd reduction)."""
    if orig_fs == target_fs:
        return n_samples
    g = gcd(int(orig_fs), int(target_fs))
    up, down = int(target_fs) // g, int(orig_fs) // g
    return -(-n_samples * up // down)


def read_wav(path: str, target_fs: int | None = None) -> tuple[np.ndarray, int]:
    """Read a WAV file; with `target_fs`, audio at any other rate is resampled.

    Returns:
        data: float32 array of shape (n_channels, n_samples), in [-1, 1).
        fs: sample rate (== target_fs when given).
    """
    with open(path, "rb") as f:
        fmt, data = _chunks(f, path, want_data=True)

    audio_format, n_channels, fs, _byte_rate, block_align, bits = struct.unpack(
        "<HHIIHH", fmt[:16]
    )
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    n_frames = len(data) // block_align
    data = data[: n_frames * block_align]

    if audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    elif audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            # sign-extend 24-bit little-endian into int32
            x32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x32 = np.where(x32 & 0x800000, x32 - 0x1000000, x32)
            x = x32.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    x = np.ascontiguousarray(x.reshape(n_frames, n_channels).T)  # (n_channels, n_samples)
    if target_fs is not None and fs != target_fs:
        x = resample(x, fs, target_fs)
        fs = target_fs
    return x, fs


def write_wav(path: str, data: np.ndarray, fs: int, bits: int = 16) -> None:
    """Write float data (n_channels, n_samples) in [-1,1] as PCM WAV. Samples are
    clipped in float64: in float32, 1 - 1e-9 is 1.0, whose code would wrap."""
    if data.ndim == 1:
        data = data[None, :]
    n_channels, n_samples = data.shape
    interleaved = np.clip(data.T.astype(np.float64), -1.0, 1.0 - 1e-9)
    if bits == 16:
        pcm = (interleaved * 32768.0).astype("<i2").tobytes()
    elif bits == 32:
        pcm = (interleaved * 2147483648.0).astype("<i4").tobytes()
    elif bits == 24:
        x32 = (interleaved * 8388608.0).astype(np.int32)
        b = np.empty((x32.size, 3), dtype=np.uint8)
        flat = x32.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        pcm = b.tobytes()
    else:
        raise ValueError(f"unsupported bit depth {bits}")
    block_align = n_channels * bits // 8
    byte_rate = fs * block_align
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, n_channels, fs, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)
