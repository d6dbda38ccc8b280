"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library of its own under
``<repo>/build/kernels/`` (git-ignored), then loaded with ``ctypes``. A
library is rebuilt when its source is newer; nothing is built when a
module is imported — only at a kernel's first launch, or when a caller
(``chip_smoke.py``) builds ahead.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def compile_library(source: Path) -> tuple[Path, str]:
    """Compile ``source`` into its shared library unless an up-to-date one
    exists. Returns ``(path, compiler output)``; raises with the
    compiler's output if ``nvcc`` fails. The library is written under a
    temporary name and renamed, so concurrent builds never load a
    half-written file."""
    source = Path(source)
    lib = library_path(source)
    if lib.exists() and lib.stat().st_mtime >= source.stat().st_mtime:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load_library(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    key = str(source)
    if key not in _LOADED:
        lib, _ = compile_library(source)
        _LOADED[key] = ctypes.CDLL(str(lib))
    return _LOADED[key]


def c_entry(source: Path, name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry ``name`` of ``source``'s library, with ``argtypes`` set
    (``ctypes.c_void_p`` for each pointer and the stream: a bare Python int
    would be cut to 32 bits) and, unless ``restype`` says otherwise, an
    ``int`` (``cudaError_t``) result."""
    fn = getattr(load_library(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def require_cuda(entry: str, t) -> None:
    """A kernel entry takes CPU tensors to its plain version and CUDA
    tensors to its kernel; any other device raises."""
    if t.device.type != "cuda":
        raise ValueError(f"no {entry} kernel for {t.device}")


def check_launch(rc: int, entry: str) -> None:
    """Raise on a launch the C entry reports as refused (``cudaError_t``)."""
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")
