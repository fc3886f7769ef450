"""Build the CUDA kernels of ``csrc/`` with nvcc at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library lives in ``build/quadray_tpu_torch/`` beside the package, named by
a hash of every file in ``csrc/`` (headers included) and the flags, so an
edited source rebuilds. ``load_libraries`` starts the builds it needs as
parallel nvcc processes. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "quadray_tpu_torch")

# no contraction into FMA, IEEE division and sqrt, never fast math: the
# golden frames depend on exact f32 boundary cases
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from source at first use")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def load_libraries(*names: str) -> list:
    """Build (if needed) and load csrc/<name>.cu for each name as a ctypes
    library; the builds that are needed run as parallel nvcc processes."""
    builds = []
    for name in names:
        if name in _LIBS:
            continue
        lib_path = _lib_path(name)
        if os.path.exists(lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        src = os.path.join(CSRC, f"{name}.cu")
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
        builds.append((name, src, tmp, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, src, tmp, lib_path, proc in builds:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed building {src} (rc {proc.returncode})"
                          f":\n{err}")
            continue
        with open(os.path.join(BUILD_DIR, f"{name}.ptxas.txt"), "w") as fh:
            fh.write(err)
        os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return [_LIBS[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu as a ctypes library."""
    if name in _LIBS:
        return _LIBS[name]
    return load_libraries(name)[0]
