"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``llzlab_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, for ``sm_90a`` (Hopper).  The hash covers the source, the
headers in ``csrc/`` and the flags, so an edited source is rebuilt and a
stale library is never loaded.  No PyTorch headers are compiled: a build takes seconds.

Nothing here runs at import time; a failed build raises with the
compiler's output.
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
from typing import Callable, Dict

from llzlab_tpu_torch.runtime.profiler import count_build, span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (on PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from llzlab_tpu_torch/csrc at first use")


def library_path(name: str) -> str:
    """Where the build of ``csrc/<name>.cu`` goes, addressed by the content
    of the source, of every header in ``csrc/`` and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current build exists; return
    the library path.  The library is written under a temporary name and
    renamed, so a concurrent builder never loads a partial file."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        count_build(name, time.perf_counter() - t0)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``declare`` sets the
    ``argtypes``/``restype`` of its entry points (without them ctypes
    passes each pointer as a 32-bit int).  Only a first load has a span
    (``llz/kernels/build``), and ``runtime.profiler.counters`` counts the
    builds that ran nvcc."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with span("kernels", "build"):
                lib = ctypes.CDLL(build(name))
                declare(lib)
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
