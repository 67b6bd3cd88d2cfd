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
there is no fallback. Both raise `KernelError`; `is_device_fault` also
names the card's own runtime errors, which the serving engine's SLO
isolation boundary lets through instead of failing one request. A
build's seconds go to `observability.device_events.note_compile`
(xla.compile_seconds under the step tag active at build time, the
goodput ledger's `compile` bucket).
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
import time

__all__ = ["library", "check", "KernelError", "is_device_fault",
           "BUILD_DIR", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# C entry -> argtypes (pointers and the stream are c_void_p: ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # x, w, y, rows, H, eps, the plan's wpr, rpb, vpt, grid, stream
    "ptt_rms_norm_bf16": (_P, _P, _P, _I, _I, _F) + (_I,) * 4 + (_P,),
    "ptt_rms_norm_f32": (_P, _P, _P, _I, _I, _F) + (_I,) * 4 + (_P,),
    # x, residual, w, y, h, rows, H, eps, stream
    "ptt_fused_add_rms_norm_bf16": (_P,) * 5 + (_I, _I, _F, _P),
    "ptt_fused_add_rms_norm_f32": (_P,) * 5 + (_I, _I, _F, _P),
    # a, w_gate_up, out, T, H, M, stream
    "ptt_swiglu_bf16": (_P, _P, _P, _I, _I, _I, _P),
    "ptt_swiglu_f32": (_P, _P, _P, _I, _I, _I, _P),
    # a, w_gate_up, dout, dgu (out), da (out), T, H, M, stream
    "ptt_swiglu_bwd_da_bf16": (_P,) * 5 + (_I,) * 3 + (_P,),
    "ptt_swiglu_bwd_da_f32": (_P,) * 5 + (_I,) * 3 + (_P,),
    # a, dgu, dw (out), T, H, M, stream
    "ptt_swiglu_bwd_dw_bf16": (_P,) * 3 + (_I,) * 3 + (_P,),
    "ptt_swiglu_bwd_dw_f32": (_P,) * 3 + (_I,) * 3 + (_P,),
    # q, k, v, o, lse, B, S, Hq, Hk, D, causal, scale, stream
    "ptt_flash_attention_fwd_bf16": (_P,) * 5 + (_I,) * 6 + (_F, _P),
    "ptt_flash_attention_fwd_f32": (_P,) * 5 + (_I,) * 6 + (_F, _P),
    # q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq, Hk, D, causal,
    # scale, stream
    "ptt_flash_attention_bwd_bf16": (_P,) * 9 + (_I,) * 6 + (_F, _P),
    "ptt_flash_attention_bwd_f32": (_P,) * 9 + (_I,) * 6 + (_F, _P),
    # o, dout, delta (out), B, S, H, D, stream
    "ptt_flash_attention_delta_bf16": (_P,) * 3 + (_I,) * 4 + (_P,),
    "ptt_flash_attention_delta_f32": (_P,) * 3 + (_I,) * 4 + (_P,),
    # q, k, v, seg_q, seg_kv (int32 or null), o, lse, B, Sq, Sk, Hq, Hk,
    # D, causal, scale, stream
    "ptt_flash_attention_seg_fwd_bf16": (_P,) * 7 + (_I,) * 7 + (_F, _P),
    "ptt_flash_attention_seg_fwd_f32": (_P,) * 7 + (_I,) * 7 + (_F, _P),
    # q, k, v, dout, lse, delta, seg_q, seg_kv, dk, dv, B, Sq, Sk, Hq, Hk,
    # D, causal, scale, stream
    "ptt_flash_attention_seg_dkv_bf16": (_P,) * 10 + (_I,) * 7 + (_F, _P),
    "ptt_flash_attention_seg_dkv_f32": (_P,) * 10 + (_I,) * 7 + (_F, _P),
    # q, k, v, dout, lse, delta, seg_q, seg_kv, dq, B, Sq, Sk, Hq, Hk, D,
    # causal, scale, stream
    "ptt_flash_attention_seg_dq_bf16": (_P,) * 9 + (_I,) * 7 + (_F, _P),
    "ptt_flash_attention_seg_dq_f32": (_P,) * 9 + (_I,) * 7 + (_F, _P),
    # q, k, v, o, lse, bias (f32), kv_valid (uint8 or null), B, Sq, Sk,
    # Hq, Hk, D, causal, kind, R, bias strides (batch, head, q, k;
    # elements), scale, stream
    "ptt_flash_attention_bias_fwd_bf16": (_P,) * 7 + (_I,) * 9 + (_LL,) * 4
                                         + (_F, _P),
    "ptt_flash_attention_bias_fwd_f32": (_P,) * 7 + (_I,) * 9 + (_LL,) * 4
                                        + (_F, _P),
    # q, k, v, dout, lse, delta, dk, dv, then as the forward from bias
    "ptt_flash_attention_bias_dkv_bf16": (_P,) * 10 + (_I,) * 9 + (_LL,) * 4
                                         + (_F, _P),
    "ptt_flash_attention_bias_dkv_f32": (_P,) * 10 + (_I,) * 9 + (_LL,) * 4
                                        + (_F, _P),
    # q, k, v, dout, lse, delta, dq, then as the forward from bias
    "ptt_flash_attention_bias_dq_bf16": (_P,) * 9 + (_I,) * 9 + (_LL,) * 4
                                        + (_F, _P),
    "ptt_flash_attention_bias_dq_f32": (_P,) * 9 + (_I,) * 9 + (_LL,) * 4
                                       + (_F, _P),
    # q, k, v, mask (uint8 rows or null), bias (f32 or null), m, l, o,
    # (bf16: the mask's bits and tile classes, scratch), B, Sq, Sk, H, D,
    # mask row bytes, bias strides (batch, head, q, k; elements), scale,
    # stream
    "ptt_block_attention_fwd_bf16": (_P,) * 10 + (_I,) * 6 + (_LL,) * 4
                                    + (_F, _P),
    "ptt_block_attention_fwd_f32": (_P,) * 8 + (_I,) * 6 + (_LL,) * 4
                                   + (_F, _P),
    # q, k_pages, v_pages, q_start, q_len, kv_len, page_table, row-tile
    # flags (or null), out, split scratch (or null), tickets, T, nh, kvh,
    # page, d, B, ppmax, keys per split, pool strides (head, page, token;
    # elements), scale, stream
    "ptt_ragged_paged_attention_bf16": (_P,) * 11 + (_I,) * 8 + (_LL,) * 3
                                       + (_F, _P),
    "ptt_ragged_paged_attention_f32": (_P,) * 11 + (_I,) * 8 + (_LL,) * 3
                                      + (_F, _P),
    # q, k_pages, v_pages, lengths, page_indices, out, split scratch (or
    # null), tickets, B, nh, kvh, page, ppseq, pages per split, d, pool
    # strides (head, page, token; elements), scale, stream
    "ptt_paged_decode_attention_bf16": (_P,) * 8 + (_I,) * 7 + (_LL,) * 3
                                       + (_F, _P),
    "ptt_paged_decode_attention_f32": (_P,) * 8 + (_I,) * 7 + (_LL,) * 3
                                      + (_F, _P),
    # logits, labels, labels are int64, loss, m, l (out), N, V,
    # ignore_index, stream
    "ptt_cross_entropy_fwd_bf16": (_P, _P, _I, _P, _P, _P, _I, _I, _LL, _P),
    "ptt_cross_entropy_fwd_f32": (_P, _P, _I, _P, _P, _P, _I, _I, _LL, _P),
    # logits, labels, labels are int64, m, l, g, dx (out), N, V,
    # ignore_index, stream
    "ptt_cross_entropy_bwd_bf16": (_P, _P, _I) + (_P,) * 4
                                  + (_I, _I, _LL, _P),
    "ptt_cross_entropy_bwd_f32": (_P, _P, _I) + (_P,) * 4
                                 + (_I, _I, _LL, _P),
    # a, q (int8), scale (f32), bias (or null), out, the plan's geometry
    # (int64 [M, K, N, group, scale strides (group row, column), splits,
    # n, grid] in host memory), tickets, split scratch (or null), stream
    "ptt_weight_only_linear_bf16": (_P,) * 9,
    "ptt_weight_only_linear_f16": (_P,) * 9,
    # a, q [K, 2 Mh] (int8), scale (f32), out, the geometry (Mh the output
    # columns), tickets, split scratch (or null), stream
    "ptt_weight_only_swiglu_bf16": (_P,) * 8,
    "ptt_weight_only_swiglu_f16": (_P,) * 8,
}

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel that did not build, load or launch."""


# messages of the CUDA runtime's and its libraries' errors as PyTorch
# raises them
_CUDA_MESSAGES = ("CUDA error", "CUBLAS_STATUS", "cuDNN error")


def is_device_fault(exc: BaseException) -> bool:
    """Whether `exc` is a kernel's (build, load, launch) or the card's
    (a CUDA runtime error, device memory exhausted) rather than a
    request's."""
    import torch
    kinds = [KernelError, torch.cuda.OutOfMemoryError, torch.cuda.CudaError]
    if hasattr(torch, "AcceleratorError"):
        kinds.append(torch.AcceleratorError)
    if isinstance(exc, tuple(kinds)):
        return True
    return (isinstance(exc, RuntimeError)
            and any(m in str(exc) for m in _CUDA_MESSAGES))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDACXX or put the CUDA "
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
            raise KernelError("nvcc failed:\n" + "\n".join(errors))
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
        if link.returncode != 0:
            raise KernelError("nvcc link failed:\n"
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
                t0 = time.perf_counter()
                _compile(so, cus)
                from ..observability import device_events
                device_events.note_compile(time.perf_counter() - t0)
        try:
            lib = ctypes.CDLL(so)
        except OSError as exc:
            raise KernelError(f"cannot load {so}: {exc}") from exc
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise KernelError(f"{what}: CUDA launch failed with error {err}")
