"""Native (C++) robot-edge components: a CPython extension built at first use.

``load()`` returns the compiled ``_stream_buffer`` module (``stream_buffer.cpp``,
the port's copy of ``kai0_tpu/native/stream_buffer.cpp``), building it on first
use with ``g++ -O3 -shared -fPIC -std=c++17`` (``$CXX`` when set) against the
interpreter's ``sysconfig`` include directory, into ``build/kai0_tpu_torch/native/``
at the root of the checkout, named by a hash of the source, the compiler, the
flags and the include directory (as ``ops/_build.py`` names the kernels'
library).

There is no fallback: a missing compiler, a failed build or a failed import
raises with the compiler's stderr (the JAX package's ``load()`` warns and
returns ``None``). ``KAI0_DISABLE_NATIVE`` set is the explicit opt-out:
``enabled()`` is false and ``load()`` raises; ``deploy.make_stream_buffer`` and
``make_ensembling_buffer`` then give the Python buffers.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pathlib
import subprocess
import sysconfig
import threading
import time

SOURCE = pathlib.Path(__file__).resolve().parent / "stream_buffer.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kai0_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_module = None
_lock = threading.Lock()
build_seconds: float | None = None  # wall time of the compiler run in this process, None if cached or unbuilt


def enabled() -> bool:
    """False when ``KAI0_DISABLE_NATIVE`` is set (to anything but an empty string)."""
    return not os.environ.get("KAI0_DISABLE_NATIVE")


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> pathlib.Path:
    """Where the extension of this source, compiler, flags and interpreter headers is built."""
    digest = hashlib.sha256(" ".join((_compiler(), *CXX_FLAGS, sysconfig.get_paths()["include"])).encode())
    digest.update(SOURCE.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_stream_buffer_{digest.hexdigest()[:16]}{suffix}"


def build() -> pathlib.Path:
    """Compile the extension unless this source has been built; return its path. Raises on any failure."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o", str(tmp)]
    start = time.perf_counter()
    try:
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (FileNotFoundError, PermissionError) as e:
        raise RuntimeError(f"the native buffers cannot be built: {cmd[0]!r} did not run ({e})") from e
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native buffers failed to build ({' '.join(cmd)}):\n{done.stderr}")
    tmp.replace(out)  # another process may have built the same file meanwhile: the same bytes
    build_seconds = round(time.perf_counter() - start, 2)
    return out


def load():
    """The compiled module, built if needed. Raises when ``KAI0_DISABLE_NATIVE`` is set or the build or import
    fails."""
    global _module
    if not enabled():
        raise RuntimeError("KAI0_DISABLE_NATIVE is set: the native buffers are switched off")
    with _lock:
        if _module is None:
            path = build()
            spec = importlib.util.spec_from_file_location("_stream_buffer", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _module = module
        return _module
