"""Build and load the CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, under ``build/kai0_tpu_torch/`` at the
root of the checkout, named by a hash of the sources and flags (a change to any
source builds a new file). The library is loaded with ``ctypes``. There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kai0_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes of the C entry points (pointers and the stream as c_void_p).
_SIGNATURES = {
    # q, k, v, mask, out, lse, part_acc, part_ml, batch, t, s, heads, head_dim, splits, chunk, is_bf16, stream
    "kai0_flash_mqa_fwd": [_P] * 8 + [_I] * 8 + [_P],
    # q, k, v, out, lse, part_acc, part_ml, batch_heads, t, s, head_dim, splits, chunk, is_bf16, stream
    "kai0_flash_mhsa_fwd": [_P] * 7 + [_I] * 7 + [_P],
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run in this process, None if cached/unbuilt


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"kai0_kernels_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels if this set of sources has not been built; return the library path."""
    global build_seconds
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_seconds = time.perf_counter() - start
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr[-8000:]}")
    os.replace(tmp, path)  # atomic: a concurrent process sees the whole file or none
    return path


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
