"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by
``nvcc`` at first use, each source in its own ``nvcc -c`` process (all
started together), and the objects are linked into one shared library
with a plain C interface.  The library is cached under the build
directory (``src/repro_torch/_build/`` unless ``REPRO_TORCH_BUILD_DIR``
names another) by a hash of the sources and flags, and loaded with
``ctypes``.  Nothing here runs at import: the CPU tests import every
module of the package, and a machine without the CUDA toolkit has no
``nvcc``.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

__all__ = ["build", "build_dir", "check", "kernel", "load", "sources"]

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, object] = {}
#: wall seconds this process spent in nvcc (0.0 if the library was cached)
build_seconds: float = 0.0


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _PKG / "_build"))


def sources() -> Sequence[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from src/repro_torch/csrc at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if the cached library is stale); its path."""
    global build_seconds
    out_dir = build_dir()
    lib = out_dir / f"librepro_torch_kernels-{_digest()}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        objs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_ARCH, *_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log = []
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if not failed:
            link = subprocess.run(
                [nvcc, *_ARCH, "-shared", *map(str, objs), "-o",
                 str(Path(tmp) / lib.name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            log.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(log)
            )
        os.replace(Path(tmp) / lib.name, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            _lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return _lib


def kernel(name: str, argtypes: Sequence) -> object:
    """C entry point ``name`` of the library with its argument types set.

    Pointers and the stream must be ``ctypes.c_void_p``: without argtypes
    ctypes would pass them as 32-bit ints and cut them.
    """
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
