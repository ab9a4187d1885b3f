"""Build and load the port's CUDA kernels.

On first use, `nvcc` compiles every `sgpt_tpu_torch/csrc/*.cu` into one
shared library with a plain C interface, for `sm_90a` (Hopper). The library
goes to `build/kernels/<hash>/` beside the package, keyed by a hash of the
sources and flags, so a changed source rebuilds and an unchanged one loads
the cached build. It is loaded with ctypes; nothing here imports PyTorch's
C++ headers, which keeps a build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_ROOT = PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libsgpt_kernels.so"


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels "
                           "cannot be built")
    return str(path)


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists.
    Returns the library's path; the compiler's output (registers, shared
    memory and spills of each kernel) is kept beside it in `build.log`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's C signature set
    (pointers and the stream as c_void_p: left undeclared, ctypes would pass
    them as 32-bit ints and cut the address)."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.sgpt_short_attention_fwd
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    lib.sgpt_cuda_error_string.argtypes = [i]
    lib.sgpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().sgpt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
