"""Build and load the port's CUDA kernels.

On first use, `nvcc` compiles each `sgpt_tpu_torch/csrc/*.cu` (they share
the `*.cuh` headers) for `sm_90a` (Hopper), one process per source, all
started together, and links the objects into one shared library with a
plain C interface. The library goes to `build/kernels/<hash>/` beside the
package, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the cached build. It is loaded with ctypes; nothing here imports PyTorch's
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    compiles = []
    for src in _sources():
        if src.suffix == ".cu":
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(out_dir / f".{src.stem}.{tag}.o"), str(src)]
            compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    log = []
    for cmd, proc in compiles:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            for _, other in compiles:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *[c[-2] for c, _ in compiles]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    for c, _ in compiles:
        os.remove(c[-2])
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    (out_dir / "build.log").write_text("".join(log))
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's C signature set
    (pointers and the stream as c_void_p: left undeclared, ctypes would pass
    them as 32-bit ints and cut the address)."""
    lib = ctypes.CDLL(str(build()))
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn = lib.sgpt_short_attention_fwd
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    fn = lib.sgpt_short_attention_bwd
    fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, i, i, i, p]
    fn.restype = i
    fn = lib.sgpt_flash_attention_fwd
    fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, f, i, i, i, i, p]
    fn.restype = i
    fn = lib.sgpt_flash_attention_bwd_dq
    fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 12 + [f, i, i, p]
    fn.restype = i
    fn = lib.sgpt_flash_attention_bwd_dkv
    fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 9 + [f, i, i, p]
    fn.restype = i
    fn = lib.sgpt_mips_topk
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = i
    fn = lib.sgpt_mips_query_block
    fn.argtypes = [i, i, i, i]
    fn.restype = i
    lib.sgpt_cuda_error_string.argtypes = [i]
    lib.sgpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().sgpt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
