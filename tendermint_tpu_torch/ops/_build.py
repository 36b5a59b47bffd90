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
import re
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


def loaded() -> bool:
    """True once the library is loaded.  Never takes the build lock, so a
    caller can ask while another thread's build is in flight."""
    return _lib is not None


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use.  Holds the build lock across
    the compile: a second caller waits for the first one's build."""
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
        cdll.ed25519_quad_selftest_launch.argtypes = [vp] * 6 + [i, vp]
        cdll.ed25519_quad_selftest_launch.restype = i
        for fn in ("bls12_381_fold_g1_launch", "bls12_381_fold_g2_launch"):
            getattr(cdll, fn).argtypes = [vp, vp, vp, i, vp]
            getattr(cdll, fn).restype = i
        # launch shapes, read by chip_smoke.py's report
        cdll.ed25519_ladder_threads.argtypes = [i]
        cdll.ed25519_table_threads.argtypes = [i, i]
        cdll.ed25519_ladder_resident_warps.argtypes = []
        cdll.ed25519_table_resident_warps.argtypes = [i]
        cdll.bls12_381_fold_threads.argtypes = [i]
        cdll.bls12_381_fold_resident_warps.argtypes = [i]
        for fn in ("ed25519_ladder_threads", "ed25519_table_threads",
                   "ed25519_ladder_resident_warps", "ed25519_table_resident_warps",
                   "bls12_381_fold_threads", "bls12_381_fold_resident_warps"):
            getattr(cdll, fn).restype = i
        _lib = cdll
        return _lib


def kernel_resources(log: str) -> dict:
    """Per kernel (mangled entry name) from a `ptxas -v` log: registers per
    thread, stack frame bytes and spill-store bytes."""
    out: dict = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"regs": None, "stack_bytes": None, "spill_bytes": None}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if m and props in out:
            out[props]["stack_bytes"], out[props]["spill_bytes"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry]["regs"] = int(m.group(1))
    return out


def resources_of(kernel: str, log: str) -> dict:
    """kernel_resources of the one entry whose mangled name holds `kernel`."""
    found = [r for name, r in kernel_resources(log).items() if kernel in name]
    if len(found) != 1:
        raise KeyError(f"{len(found)} entries named like {kernel!r} in the ptxas log")
    return found[0]
