"""Build and load the package's native sources (``desr_tpu_torch/csrc/``).

Each source is compiled on first use into a shared library with a plain C
interface under ``desr_tpu_torch/_build/`` (listed in ``.gitignore``) and
loaded with ``ctypes``: a CUDA source (``*.cu``) with ``nvcc`` for
``sm_90a``, a host C++ source (``*.cpp``, the PNG decoder) with the host
compiler ``g++``, which ``nvcc`` needs anyway. Nothing here runs when the
package is imported; the first CUDA call of a kernel wrapper, or the first
native image decode, triggers the build. A library whose file name carries
the source's hash is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
HOST_LIBS = {"dataio": ["-lz"]}  # libraries each host source links

_lock = threading.Lock()
_libs: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built from source on first use")


def find_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the native image decoders are built "
                           "from source on first use")
    return cxx


def _source(name: str) -> str:
    """``csrc/<name>.cu`` (CUDA) or ``csrc/<name>.cpp`` (host C++)."""
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR, f"{name}.cpp")


def _flags(src: str) -> list:
    return NVCC_FLAGS if src.endswith(".cu") else HOST_FLAGS


def library_path(name: str) -> str:
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` or ``.cpp`` unless its library exists;
    return its path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    src = _source(name)
    if src.endswith(".cu"):
        cmd = [find_nvcc(), *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
    else:
        cmd = [find_cxx(), *HOST_FLAGS]
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: another process building the
    # same source at the same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd += ["-o", tmp, src] + HOST_LIBS.get(name, [])
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed for "
                               f"{os.path.basename(src)}:\n{res.stderr}")
        if verbose and res.stderr:
            # ptxas -v: registers, shared memory and spills per kernel, and
            # its warnings; its info notes on injected warpgroup.arrive
            # (C7519) are counted, not listed
            lines = res.stderr.splitlines()
            print("\n".join(ln for ln in lines if "(C7519)" not in ln))
            print(f"ptxas: {sum('(C7519)' in ln for ln in lines)} C7519 notes for {name}.cu")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib
