"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (sm_90a).

The JAX package `paddle_tpu` is the reference; this package keeps its
module and function names so each counterpart is easy to find, and
never imports `jax` or `paddle_tpu`. Every Pallas kernel on a ported
path is a hand-written CUDA kernel under `csrc/`, built on first use by
`kernels/_build.py`, with a plain PyTorch version beside it that CPU
tensors take.

Ported so far (the serving slice): framework.core flags, the RMSNorm,
SwiGLU and ragged paged attention kernels, the LLaMA serving step over
the paged KV pool, the chunked-prefill continuous-batching engine with
the prefix cache, and the HTTP gateway + `serve` CLI.

Entry points run on `cuda` unless the caller passes `device="cpu"`;
with no card and no explicit CPU request they raise.
"""
from .framework.core import (get_bool_flag, get_flag,  # noqa: F401
                             resolve_device, seed, set_flags)

__all__ = ["get_bool_flag", "get_flag", "resolve_device", "seed",
           "set_flags"]
