"""ctypes bindings for the native C++ WAV batch loader.

Builds ``libwavloader.so`` on first use (g++ is in the image; pybind11 is
not, so the C ABI + ctypes is the binding layer).  Falls back to the pure
Python loader when a toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "wavloader.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "native", "libwavloader.so")
_lock = threading.Lock()
_lib = None


def _build() -> bool:
    # built under a name of this process's own and renamed into place, so
    # that processes starting together (data-parallel ranks) never load a
    # library another one is still writing
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, _LIB)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            if not _build():
                return None
        lib = ctypes.CDLL(_LIB)
        lib.wavloader_create.restype = ctypes.c_void_p
        lib.wavloader_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.wavloader_next.restype = ctypes.c_int
        lib.wavloader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_float)]
        lib.wavloader_destroy.argtypes = [ctypes.c_void_p]
        lib.wavloader_decode.restype = ctypes.c_int
        lib.wavloader_decode.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


class NativeWavLoader:
    """Infinite iterator of (clean, noisy) float32 batches decoded and
    cropped by C++ worker threads (replaces torch DataLoader workers)."""

    def __init__(
        self,
        clean_paths: List[str],
        noisy_paths: List[str],
        crop_len: int,
        batch_size: int,
        n_threads: int = 4,
        queue_depth: int = 4,
        seed: int = 0,
    ):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        assert len(clean_paths) == len(noisy_paths) and clean_paths
        self._lib = lib
        self.batch_size = batch_size
        self.crop_len = crop_len
        self._handle = lib.wavloader_create(
            "\n".join(clean_paths).encode(),
            "\n".join(noisy_paths).encode(),
            crop_len, batch_size, n_threads, queue_depth,
            ctypes.c_uint64(seed),
        )
        if not self._handle:
            raise RuntimeError("wavloader_create failed")

    def __iter__(self):
        return self

    def __next__(self):
        clean = np.empty((self.batch_size, self.crop_len), np.float32)
        noisy = np.empty((self.batch_size, self.crop_len), np.float32)
        rc = self._lib.wavloader_next(
            self._handle,
            clean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            noisy.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise StopIteration
        return clean, noisy

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.wavloader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def decode_wav_native(path: str, max_len: int = 16000 * 120) -> Optional[np.ndarray]:
    """Single-file decode through the native reader (None if unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.empty((max_len,), np.float32)
    n = lib.wavloader_decode(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len)
    if n < 0:
        return None
    return buf[:n].copy()
