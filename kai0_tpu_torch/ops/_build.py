"""Build and load the CUDA kernels in ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` process per source, all started together) and links the objects into
one shared library with a plain C interface, under ``build/kai0_tpu_torch/`` at
the root of the checkout, named by a hash of the sources and flags (a change to
any source builds a new file). The library is loaded with ``ctypes``. There is
no fallback: a missing ``nvcc`` or a failed build raises.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes of the C entry points (pointers and the stream as c_void_p).
_SIGNATURES = {
    # q, k, v, mask, out, lse, part_acc, part_ml, batch, t, s, heads, head_dim, splits, chunk, is_bf16, stream
    "kai0_flash_mqa_fwd": [_P] * 8 + [_I] * 8 + [_P],
    # q, k, v, out, lse, part_acc, part_ml, batch_heads, t, s, head_dim, splits, chunk, is_bf16, stream
    "kai0_flash_mhsa_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # q, k, v, mask, out, dout, lse, delta, dq, dk, dv, batch, t, s, heads, head_dim, is_bf16, stream
    "kai0_flash_mqa_bwd": [_P] * 11 + [_I] * 6 + [_P],
    # q, k, v, out, dout, lse, delta, dq, dk, dv, batch_heads, t, s, head_dim, is_bf16, stream
    "kai0_flash_mhsa_bwd": [_P] * 10 + [_I] * 5 + [_P],
    # g, mq, ms, vq, vs, out, n, b1, 1-b1, b2, 1-b2, a, b, step_s, step_u, seed, deterministic, is_bf16, stream
    "kai0_adam_q8": [_P] * 6 + [ctypes.c_longlong] + [_F] * 8 + [ctypes.c_uint, _I, _I, _P],
    # table, leaves, blocks, b1, 1-b1, b2, 1-b2, a, b, step_s, step_u, deterministic, stream
    "kai0_adam_q8_leaves": [_P, _I, _I] + [_F] * 8 + [_I, _P],
    # x, col_scale (or null), xq, sx, m, k, is_bf16, stream
    "kai0_row_quant": [_P] * 4 + [_I] * 3 + [_P],
    # xq, w, sx, sn (or null), out, m, n, k, nt, out_bf16, stream
    "kai0_int8_mm": [_P] * 5 + [_I] * 5 + [_P],
    # xq, w, sx, sn, u, b, out, m, n, k, rank, is_bf16, stream
    "kai0_int8_mm_lora": [_P] * 7 + [_I] * 5 + [_P],
    # xq, w, sx, sn (or null), out, ws, counters, m, n, k, bn, splits, chunk, out_bf16, stream
    "kai0_int8_mm_splitk": [_P] * 7 + [_I] * 7 + [_P],
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
    work = path.with_suffix(f".{os.getpid()}.objs")
    work.mkdir(exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src in _sources():
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(work / f"{src.stem}.o"), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err[-8000:]}")
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, sorted(work.glob("*.o")))]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr[-8000:]}")
    build_seconds = time.perf_counter() - start
    path.with_suffix(".log").write_text("\n".join(log))
    shutil.rmtree(work, ignore_errors=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
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
