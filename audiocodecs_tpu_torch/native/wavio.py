"""ctypes binding of the native WAV reader and writer
(``audiocodecs_tpu_torch/csrc/wavio.cc``).

The port's own copy of the reference's binding: the library is built at
first use with one ``g++ -O3 -shared -fPIC`` into the git-ignored
``audiocodecs_tpu_torch/_build/``, under a name that carries a hash of the
source and the flags (as :mod:`..ops._build` names the CUDA libraries), so
an edited source is rebuilt. There is no switch and no fallback: when the
build or the load fails, the call raises. The stdlib ``wave`` path of
:mod:`..utils.audio` is the plain version, chosen by its caller.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
from pathlib import Path

import numpy as np

__all__ = ["library_path", "load", "read_wav_native", "write_wav_native"]

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "csrc" / "wavio.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"wavio-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.is_file():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                           "WAV library is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for wavio.cc:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The library, built if needed, loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.wavio_read.restype = ctypes.c_int
            lib.wavio_read.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.wavio_write.restype = ctypes.c_int
            lib.wavio_write.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,
            ]
            lib.wavio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.wavio_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def read_wav_native(path: str) -> tuple[np.ndarray, int]:
    """Read PCM 8/16/24/32-bit or float32 WAV → (``[channels, T]`` float32,
    sample_rate). The array views the library's buffer, freed when the
    array and every view of it are collected."""
    lib = load()
    data = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.wavio_read(os.fsencode(path), ctypes.byref(data),
                        ctypes.byref(frames), ctypes.byref(channels),
                        ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"wavio_read({path}): {lib.wavio_error().decode()}")
    n, ch = frames.value, channels.value
    if n * ch == 0:
        lib.wavio_free(data)
        return np.zeros((ch, 0), np.float32), rate.value
    arr = np.ctypeslib.as_array(data, shape=(n * ch,))
    weakref.finalize(arr, lib.wavio_free, data)
    return arr.reshape(n, ch).T, rate.value


def write_wav_native(path: str, sig: np.ndarray, sample_rate: int,
                     bits: int = 16) -> None:
    """Write ``[channels, T]`` or ``[T]`` float audio as PCM16 (clipped,
    ``x * 32767`` truncated toward zero, as numpy's ``astype``) or as
    float32 (``bits=32``)."""
    lib = load()
    sig = np.asarray(sig, dtype=np.float32)
    if sig.ndim == 1:
        sig = sig[None]
    inter = np.ascontiguousarray(sig.T.reshape(-1))
    rc = lib.wavio_write(
        os.fsencode(path), inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sig.shape[1], sig.shape[0], int(sample_rate), int(bits))
    if rc != 0:
        raise ValueError(f"wavio_write({path}): {lib.wavio_error().decode()}")
