"""Build the port's CUDA kernels and its host C++ at first use and load
them with ctypes.

Each kernel source under ``csrc/`` compiles with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds); the MATSim parser under ``native/`` compiles with the host's
C++ compiler (:func:`load_host_library`).  Libraries go to
``build/tarl_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``, for the kernels) and the
command, so an edited source rebuilds.  A failed compile raises with the
compiler's stderr.
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
# The host C++ compiler and its flags; no -march=native, so that what the
# code computes does not depend on the host's vector units.
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

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


def _built(name: str, digest_of: bytes, command) -> Path:
    """The library ``lib<name>_<hash>.so`` under :data:`BUILD_DIR`, keyed
    by ``digest_of``; ``command(output)`` builds it where it is missing."""
    digest = hashlib.sha256(digest_of).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = command(tmp)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cmd[0]} failed to build lib{name}: {e}")
        if proc.returncode != 0:
            if tmp.exists():
                tmp.unlink()
            raise RuntimeError(
                f"{cmd[0]} failed to build lib{name}:\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name in _LOADED:
        return _LOADED[name]
    source = PACKAGE_DIR / "csrc" / f"{name}.cu"
    headers = sorted((PACKAGE_DIR / "csrc").glob("*.cuh"))
    lib_path = _built(
        name, source.read_bytes() + b"".join(h.read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode(),
        lambda out: nvcc_command(source, out))
    _LOADED[name] = ctypes.CDLL(str(lib_path))
    return _LOADED[name]


def load_host_library(name: str, source: Path, defines=(),
                      libs=()) -> ctypes.CDLL:
    """Compile the C++ file ``source`` with :data:`CXX` and
    :data:`CXX_FLAGS` (and ``-D`` each of ``defines``, linking ``-l`` each
    of ``libs``) if its library is missing, then load it.  Raises
    ``RuntimeError`` with the compiler's stderr where it fails."""
    flags = CXX_FLAGS + [f"-D{d}" for d in defines]
    link = [f"-l{lib}" for lib in libs]

    def command(out):
        return [CXX, *flags, "-o", str(out), str(source), *link]

    lib_path = _built(name, source.read_bytes() + " ".join(
        [CXX, *flags, *link]).encode(), command)
    return ctypes.CDLL(str(lib_path))
