"""salsa_tpu_torch.utils.audio_io against salsa_tpu.utils.audio_io: the decoded
samples are bit-equal at PCM 8/16/24/32, float 32/64 and WAVE_FORMAT_EXTENSIBLE,
header probes and resampled lengths agree, 48 -> 24 kHz resampling is bit-equal,
and the writers write the same bytes."""
import struct

import numpy as np
import pytest

from salsa_tpu.utils import audio_io as jaudio
from salsa_tpu_torch.utils import audio_io as taudio


def _wav_bytes(samples: np.ndarray, fs: int, fmt_code: int, bits: int,
               extensible: bool = False, extra_chunk: bytes = b"") -> bytes:
    """A RIFF/WAVE file of interleaved (n, ch) samples already in their raw dtype
    (24-bit: (n, ch, 3) bytes)."""
    n_ch = samples.shape[1]
    block_align = n_ch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHH", 0xFFFE, n_ch, fs, fs * block_align, block_align, bits)
        # cbSize 22, valid bits, channel mask, then the sub-format GUID's first 2 bytes
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt_code) + b"\x00" * 14
    else:
        fmt = struct.pack("<HHIIHH", fmt_code, n_ch, fs, fs * block_align, block_align, bits)
    data = samples.tobytes()
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + extra_chunk
    body += b"data" + struct.pack("<I", len(data)) + data + (b"\x00" if len(data) % 2 else b"")
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _pcm24(x: np.ndarray) -> np.ndarray:
    v = x.astype(np.int32).reshape(-1)
    b = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], axis=-1).astype(np.uint8)
    return b.reshape(x.shape + (3,))


def _cases(rng):
    n, ch = 1001, 3
    return {
        "pcm8": (rng.integers(0, 256, (n, ch)).astype(np.uint8), 1, 8),
        "pcm16": (rng.integers(-32768, 32768, (n, ch)).astype("<i2"), 1, 16),
        "pcm24": (_pcm24(rng.integers(-2**23, 2**23, (n, ch))), 1, 24),
        "pcm32": (rng.integers(-2**31, 2**31, (n, ch)).astype("<i4"), 1, 32),
        "float32": (rng.uniform(-1, 1, (n, ch)).astype("<f4"), 3, 32),
        "float64": (rng.uniform(-1, 1, (n, ch)).astype("<f8"), 3, 64),
    }


@pytest.mark.parametrize("extensible", [False, True], ids=["plain", "extensible"])
@pytest.mark.parametrize("kind", ["pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64"])
def test_read_wav_bit_equal(tmp_path, rng, kind, extensible):
    samples, code, bits = _cases(rng)[kind]
    path = tmp_path / f"{kind}.wav"
    # an odd-sized chunk before the data: both readers must skip its pad byte
    path.write_bytes(_wav_bytes(samples, 16000, code, bits, extensible,
                                extra_chunk=b"LIST" + struct.pack("<I", 3) + b"abc\x00"))
    got, fs = taudio.read_wav(str(path))
    want, want_fs = jaudio._read_wav_py(str(path))
    assert fs == want_fs == 16000 and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 1001) and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jaudio.read_wav(str(path))[0])  # its default path
    assert taudio.wav_info(str(path)) == jaudio.wav_info(str(path)) == (3, 1001, 16000)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_write_wav_same_bytes(tmp_path, rng, bits):
    x = rng.uniform(-1.0, 1.0 - 2.0 ** -20, (4, 2400)).astype(np.float32)
    x[0, :2] = (-1.0, 0.0)
    a, b = tmp_path / "port.wav", tmp_path / "jax.wav"
    taudio.write_wav(str(a), x, 24000, bits=bits)
    jaudio.write_wav(str(b), x, 24000, bits=bits)
    assert a.read_bytes() == b.read_bytes()
    got, _ = taudio.read_wav(str(a))
    assert np.abs(got - x).max() <= 2.0 ** (1 - bits)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_write_wav_clips_full_scale_float32(tmp_path, bits):
    """float32 samples at or above 1 - 2^-24 clip to the largest code; salsa_tpu's
    writer clips them in float32 to 1.0, whose code wraps to the most negative."""
    x = np.array([[1.0, 1.5, 1.0 - 2.0 ** -24, -1.5, 0.5]], np.float32)
    taudio.write_wav(str(tmp_path / "x.wav"), x, 8000, bits=bits)
    got, _ = taudio.read_wav(str(tmp_path / "x.wav"))
    top = np.float32(1.0 - 2.0 ** (1 - bits))  # the largest code, read back
    assert got[0, 0] == got[0, 1] == top and 0.999 < got[0, 2] <= top
    assert got[0, 3] == -1.0 and got[0, 4] == 0.5


def test_resample_48k_to_24k_bit_equal(tmp_path, rng):
    x = rng.uniform(-0.9, 0.9, (4, 48000 + 37)).astype(np.float32)
    path = tmp_path / "48k.wav"
    jaudio.write_wav(str(path), x, 48000, bits=16)
    got, fs = taudio.read_wav(str(path), target_fs=24000)
    want, want_fs = jaudio.read_wav(str(path), target_fs=24000)
    assert fs == want_fs == 24000 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == taudio.resampled_length(48037, 48000, 24000) == 24019
    np.testing.assert_array_equal(taudio.resample(x, 44100, 24000),
                                  jaudio.resample(x, 44100, 24000))
    assert taudio.resample(x, 24000, 24000) is x


@pytest.mark.parametrize("n", [0, 1, 2, 999, 48000, 1440001])
@pytest.mark.parametrize("orig,target", [(48000, 24000), (44100, 24000), (16000, 24000),
                                         (24000, 24000), (22050, 48000)])
def test_resampled_length_equal(n, orig, target):
    got = taudio.resampled_length(n, orig, target)
    assert got == jaudio.resampled_length(n, orig, target)
    if 0 < n < 50000:
        assert got == taudio.resample(np.zeros((1, n), np.float32), orig, target).shape[1]


@pytest.mark.parametrize("blob,match", [
    (b"RIFX\x00\x00\x00\x00WAVE", "RIFF/WAVE"),
    (b"RIFF\x04\x00\x00\x00WAVEfmt \x10\x00\x00\x00" + b"\x01\x00" * 8, "missing"),
], ids=["not-riff", "no-data"])
def test_malformed_wavs_are_refused(tmp_path, blob, match):
    path = tmp_path / "bad.wav"
    path.write_bytes(blob)
    for reader in (taudio.read_wav, taudio.wav_info):
        with pytest.raises(ValueError, match=match):
            reader(str(path))


@pytest.mark.parametrize("code,bits", [(1, 12), (3, 16), (2, 16)], ids=["pcm12", "float16",
                                                                        "adpcm"])
def test_unsupported_encodings_are_refused(tmp_path, code, bits):
    path = tmp_path / "odd.wav"
    path.write_bytes(_wav_bytes(np.zeros((4, 1), np.uint16), 8000, code, bits))
    with pytest.raises(ValueError, match="unsupported"):
        taudio.read_wav(str(path))
    with pytest.raises(ValueError, match="unsupported"):
        taudio.write_wav(str(tmp_path / "x.wav"), np.zeros((1, 4)), 8000, bits=8)
