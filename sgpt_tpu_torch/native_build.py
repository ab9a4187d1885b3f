"""Build the host-side native libraries (`native/*.cpp`) for the port.

Each `native/Makefile` target is compiled into `build/native/<hash>/`
beside the package, keyed by a hash of the native sources, so a changed
source rebuilds and an unchanged one loads the cached build. The port never
loads a library from `native/` itself: the JAX package remakes those files
in place (`make -B`), and a process that loads one while another process
rewrites it gets a missing or partly written file. Here one build runs at a
time, under an `fcntl` lock, in a temporary directory holding a copy of the
sources; the product is renamed into place, so a loader sees all of it or
nothing.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE = Path(__file__).resolve().parent.parent / "native"
BUILD_ROOT = NATIVE.parent / "build" / "native"


def _sources() -> dict:
    return {p.name: p.read_bytes() for p in sorted(NATIVE.iterdir())
            if p.suffix in (".cpp", ".h") or p.name == "Makefile"}


def build(target: str) -> str:
    """The path of `target` (a `native/Makefile` target) built from the
    current sources, making it first if no such build exists. Raises if
    `make` fails."""
    sources = _sources()
    h = hashlib.sha256()
    for name, data in sources.items():
        h.update(name.encode())
        h.update(data)
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / target
    if lib.exists():
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not lib.exists():
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                for name, data in sources.items():
                    Path(tmp, name).write_bytes(data)
                subprocess.run(["make", "-C", tmp, target], check=True, capture_output=True)
                os.replace(os.path.join(tmp, target), lib)
    return str(lib)
