"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so`` through
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` (a plain C interface
with no PyTorch headers, which keeps the build short), keyed by a hash of the
sources and flags so an edited kernel is rebuilt.  Loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source.  selective_scan.cu instantiates 54 kernels; nvcc
# optimises them in parallel threads with -split-compile=0 (64 s against
# 139 s on the 8 cores beside an NVIDIA H100 80GB HBM3).  stream_mega.cu's
# two kernels and their shared contraction cores take 20-36 s there;
# stream_fused.cu instantiates 54 kernels since its int8 weight type.
SOURCE_FLAGS = {name: ("-split-compile=0",)
                for name in ("selective_scan", "stream_mega", "stream_fused")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    return path


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def _digest(src: pathlib.Path) -> str:
    h = hashlib.sha256(" ".join(_flags(src.stem)).encode())
    for f in sorted(src.parent.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load_library(name: str, csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """Build (if its sources changed) and load ``csrc/<name>.cu``.

    ``csrc``: the sources' directory (another checkout's, to time an earlier
    version of a kernel beside this one).  Raises if ``nvcc`` is missing or
    the build fails; the compiler's output (with ``-Xptxas -v``: registers,
    shared memory, spills per kernel) is written beside the library as
    ``.log``.
    """
    src = pathlib.Path(csrc) / f"{name}.cu"
    lib = BUILD_DIR / f"lib{name}-{_digest(src)}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *_flags(name), "-I", str(src.parent), "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def require_cuda(what: str, device: torch.device, **tensors) -> None:
    """Every tensor given must be a contiguous tensor on ``device``."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
