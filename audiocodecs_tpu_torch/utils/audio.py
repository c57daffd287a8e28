"""Host-side audio I/O and a test signal (numpy, no torch).

Counterpart of ``audiocodecs_tpu/utils/audio.py``. WAV files go through the
package's native reader and writer (``csrc/wavio.cc`` over ctypes,
:mod:`..native.wavio`: one C++ pass for parse and int → float, float32
WAVs too). ``native=False`` takes the plain version, Python's ``wave``
module and numpy, with the same numerics (PCM integers scaled to
``[-1, 1)``; written as 16-bit PCM, ``x * 32767`` truncated toward zero):
both give the same arrays and the same bytes.
"""

from __future__ import annotations

import wave

import numpy as np

__all__ = ["read_wav", "write_wav", "example_signal"]


def read_wav(path: str, native: bool = True) -> tuple[np.ndarray, int]:
    """Read a PCM WAV file → (``[channels, T]`` float32 in [-1, 1],
    sample_rate). Sample widths of 1 (unsigned), 2, 3 and 4 bytes; the
    native reader also reads float32 files."""
    if native:
        from audiocodecs_tpu_torch.native.wavio import read_wav_native

        return read_wav_native(path)
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = (np.frombuffer(raw, dtype="<i4").astype(np.float32)
                / 2147483648.0)
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width: {width}")
    return data.reshape(-1, ch).T, sr


def write_wav(path: str, sig: np.ndarray, sample_rate: int,
              native: bool = True) -> None:
    """Write ``[channels, T]`` or ``[T]`` float audio as 16-bit PCM WAV
    (clipped to the int16 range)."""
    if native:
        from audiocodecs_tpu_torch.native.wavio import write_wav_native

        return write_wav_native(path, sig, sample_rate)
    sig = np.asarray(sig, dtype=np.float32)
    if sig.ndim == 1:
        sig = sig[None]
    pcm = np.clip(sig.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(sig.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def example_signal(sample_rate: int = 24000,
                   seconds: float = 1.0) -> np.ndarray:
    """Deterministic speech-band test signal ``[T]`` float32: a rising chirp
    from 110 Hz with two harmonics, a 50 ms fade-in and a 3 Hz tremolo."""
    t = np.arange(int(sample_rate * seconds), dtype=np.float64) / sample_rate
    f0 = 110.0 * 2 ** (t * 1.5)  # rising chirp
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    sig = (0.45 * np.sin(phase) + 0.25 * np.sin(2.01 * phase)
           + 0.12 * np.sin(3.02 * phase))
    env = 0.5 - 0.5 * np.cos(2 * np.pi * np.minimum(t / 0.05, 1.0) / 2)
    sig *= env * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t) ** 2)
    return sig.astype(np.float32)
