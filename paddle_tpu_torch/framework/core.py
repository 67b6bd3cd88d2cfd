"""Flag registry, seeding and device resolution (counterpart of
paddle_tpu/framework/core.py).

Only the flags the serving slice reads are registered, with the
reference's names and defaults; `get_flag` reads the environment first,
as the reference does, and `get_bool_flag` normalises env strings so
`FLAGS_x=0` turns a kill switch off.
"""
from __future__ import annotations

import os

import torch

__all__ = ["set_flags", "get_flag", "get_bool_flag", "seed",
           "resolve_device"]

_flags: dict = {
    # fused transformer hot path: the serving blocks run the wide QKV
    # projection + rope prologue; 0 restores the unfused projections, and
    # on the CPU also the unfused MLP expression (the card always runs
    # the RMSNorm and SwiGLU kernels)
    "FLAGS_fused_transformer": True,
    # ragged paged attention + chunked-prefill continuous batching (the
    # bucketed regime it switches back to is not ported yet)
    "FLAGS_ragged_attention": True,
    # prefix caching over the KV page pool; 0 drops the index
    "FLAGS_prefix_cache": True,
}

_FALSY = (False, None, 0, 0.0, "0", "false", "False", "", "off", "OFF")


def set_flags(flags: dict) -> None:
    for k, v in flags.items():
        _flags[k] = v


def get_flag(key, default=None):
    env = os.environ.get(key)
    if env is not None:
        return env
    return _flags.get(key, default)


def get_bool_flag(key, default=False) -> bool:
    """Boolean view of a flag: env-set flags arrive as strings, so
    bool('0') would invert every kill switch — normalise here."""
    return get_flag(key, default) not in _FALSY


def seed(s: int) -> torch.Generator:
    """Seed torch's global generators (CPU and every CUDA device) and
    return a CPU `torch.Generator` seeded with `s`. Code that samples
    takes an explicit generator; this is for callers that want one."""
    torch.manual_seed(int(s))
    g = torch.Generator()
    g.manual_seed(int(s))
    return g


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller
    names another. With no card and no explicit request this raises —
    an entry point never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch route on the CPU")
        if dev.index is None:
            # pin the index: a thread that selects this device later
            # (torch.cuda.set_device) needs one
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
