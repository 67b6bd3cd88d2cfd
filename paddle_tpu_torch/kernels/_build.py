"""Build-on-first-use loader for the port's CUDA kernels (the
counterpart of paddle_tpu/utils/_native_build.py's lock-and-staleness
convention, for nvcc instead of g++).

Every `paddle_tpu_torch/csrc/*.cu` is compiled for sm_90a with a plain
C interface and linked into ONE shared library, loaded with ctypes (no
PyTorch headers: a build takes seconds, not minutes). The library name
carries a hash of the sources and flags, so an edited kernel can never
load a stale build. Each source compiles in its own nvcc process, all
started together, then one link. A file lock serialises builds in
different processes; the finished .so is installed by atomic rename so
a concurrent loader never opens a half-written file.

Every C entry returns `cudaGetLastError()` after its launch; `check`
raises when it is not 0. A build failure raises with nvcc's output —
there is no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["library", "check", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes (pointers and the stream are c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # x, w, y, rows, H, eps, stream
    "ptt_rms_norm_bf16": (_P, _P, _P, _I, _I, _F, _P),
    "ptt_rms_norm_f32": (_P, _P, _P, _I, _I, _F, _P),
    # a, w_gate_up, out, T, H, M, stream
    "ptt_swiglu_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "ptt_swiglu_f32": (_P, _P, _P, _I, _I, _I, _P),
    # q, k_pages, v_pages, q_start, q_len, kv_len, page_table, out,
    # T, nh, kvh, n_pages, page, d, B, ppmax, scale, stream
    "ptt_ragged_paged_attention_bf16": (_P,) * 8 + (_I,) * 8 + (_F, _P),
    "ptt_ragged_paged_attention_f32": (_P,) * 8 + (_I,) * 8 + (_F, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDACXX or put the CUDA "
                       "toolkit's bin on PATH)")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(so: str, cus) -> None:
    nvcc = _nvcc()
    tmp = f"{so}.tmp.{os.getpid()}"
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", cu, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for cu, obj in zip(cus, objs)]
    errors = []
    try:
        for cu, p in zip(cus, procs):
            out, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                errors.append(f"{cu}:\n{out.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp, so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when no build of
    the current sources exists."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cus = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
        so = os.path.join(BUILD_DIR,
                          f"libpaddle_tpu_torch_{_digest(cus + headers)}.so")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(so + ".lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            if not os.path.exists(so):
                _compile(so, cus)
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
