"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` is compiled by its own `nvcc` process for `sm_90a`, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes (pointers and the stream pass as
`c_void_p`).  No PyTorch headers are compiled, so a build takes seconds.
The library lands in the package's `_build/` directory under a name that
embeds a hash of the sources and flags, so a stale library is never loaded;
it is built at first use.  A failed build raises with nvcc's stderr.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, headers


def library_path() -> str:
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"tm_kernels-{h.hexdigest()[:16]}.so")


def ptxas_log_path() -> str:
    return library_path()[: -len(".so")] + ".ptxas.log"


def _compile(so: str) -> None:
    nvcc = _nvcc()
    cu, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    procs = []
    try:
        for src in cu:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, objs = [], []
        for src, obj, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {os.path.basename(src)}:\n{out}{err}")
            logs.append(f"== {os.path.basename(src)}\n{err}")
            objs.append(obj)
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        with open(ptxas_log_path(), "w") as f:
            f.write("\n".join(logs))
        os.replace(tmp, so)
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        cdll = ctypes.CDLL(so)
        vp, i = ctypes.c_void_p, ctypes.c_int
        cdll.ed25519_ladder_launch.argtypes = [vp] * 9 + [i, i, vp]
        cdll.ed25519_ladder_launch.restype = i
        cdll.ed25519_tabulated_launch.argtypes = [vp] * 9 + [i, i, vp]
        cdll.ed25519_tabulated_launch.restype = i
        cdll.ed25519_window_tables_launch.argtypes = [vp, vp, i, vp]
        cdll.ed25519_window_tables_launch.restype = i
        _lib = cdll
        return _lib
