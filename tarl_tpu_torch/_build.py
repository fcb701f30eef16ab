"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/tarl_tpu_torch/`` at the root of the
checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the command, so an edited source rebuilds.  A failed
compile raises with nvcc's stderr.
:func:`check_tensor` is the wrappers' check of what a kernel takes, and
:func:`current_stream` the stream they launch on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tarl_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# No fast math, no contraction into FMAs: the kernels must round exactly as
# their PyTorch plain versions do.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "--fmad=false", "-shared",
                           "-Xcompiler", "-fPIC"]

_LOADED: dict[str, ctypes.CDLL] = {}


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` lies on ``device`` with ``dtype``,
    ``shape`` and a contiguous layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def current_stream(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (an indexed CUDA
    device, as a tensor's is), as the raw ``cudaStream_t`` a kernel
    launches on.  The same stream as ``torch.cuda.current_stream(device).
    cuda_stream``, read without building a ``Stream`` object: this is on
    every launch's host path."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def nvcc_command(source: Path, output: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(output), str(source)]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name in _LOADED:
        return _LOADED[name]
    source = PACKAGE_DIR / "csrc" / f"{name}.cu"
    headers = sorted((PACKAGE_DIR / "csrc").glob("*.cuh"))
    digest = hashlib.sha256(
        source.read_bytes() + b"".join(h.read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(nvcc_command(source, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    _LOADED[name] = ctypes.CDLL(str(lib_path))
    return _LOADED[name]
