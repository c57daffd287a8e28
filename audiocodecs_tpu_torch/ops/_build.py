"""Build the package's CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface, under ``audiocodecs_tpu_torch/_build/``
(listed in ``.gitignore``). The library's file name carries a hash of the
sources and flags, so an edited source is rebuilt. There is no
``--use_fast_math``: ``expf``/``tanhf``/``expm1f`` decide encoder tokens,
and ``sinf`` must stay accurate for large arguments of the snake.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["KERNELS", "build", "build_all", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("lstm_recurrence", "seanet_resblock", "dac_resunit")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; None when its library is current."""
    out = _library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all(names=KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` at once (one ``nvcc`` each) and
    return the wall seconds until all were built (0.0 when current)."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
    dt = time.perf_counter() - t0
    return {n: (dt if started[n] is not None else 0.0) for n in names}


def build(name: str) -> Path:
    build_all((name,))
    return _library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built if needed, loaded once per process."""
    with _lock:
        lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        with _lock:
            lib = _loaded.setdefault(name, lib)
    return lib
