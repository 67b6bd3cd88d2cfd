"""Flag registry, seeding, device resolution and the armed remat
policy (counterpart of paddle_tpu/framework/core.py).

Only the flags the ported slices read are registered, with the
reference's names and defaults (the serving features not yet ported
default to the reference's kill switches); `get_flag` reads the environment first,
as the reference does, and `get_bool_flag` normalises env strings so
`FLAGS_x=0` turns a kill switch off.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["set_flags", "get_flag", "get_bool_flag", "seed",
           "resolve_device", "current_remat_policy", "remat_policy_guard"]

_flags: dict = {
    # fused transformer hot path: the serving blocks run the wide QKV
    # projection + rope prologue; 0 restores the unfused projections, and
    # on the CPU also the unfused MLP expression (the card always runs
    # the RMSNorm and SwiGLU kernels)
    "FLAGS_fused_transformer": True,
    # ragged paged attention + chunked-prefill continuous batching; 0
    # switches the engine to the bucketed-prefill regime
    "FLAGS_ragged_attention": True,
    # prefix caching over the KV page pool; 0 drops the index
    "FLAGS_prefix_cache": True,
    # flash attention in the training forward; 0 is the reference's dense
    # ablation, which the card refuses (no dense attention runs there)
    "FLAGS_use_flash_attention": True,
    # big-vocab hard-label cross-entropy through the fused kernels
    # (kernels/cross_entropy.py) on a CUDA tensor; 0, the default, keeps
    # the plain f32 log-softmax route, as in the reference
    "FLAGS_use_fused_ce": False,
    # Serving features the reference arms by default (its defaults:
    # True, 4, True, True). They stand here at the reference's
    # kill-switch values until ROADMAP Queue 1 items 1 (speculative
    # decoding), 2 (the SLO layer) and 5 (request tracing) port the
    # features; `ContinuousBatchingEngine` raises NotImplementedError
    # when one resolves on.
    "FLAGS_speculative": False,
    "FLAGS_speculative_draft_tokens": 0,
    "FLAGS_serving_slo": False,
    "FLAGS_request_trace": False,
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


# ---------------------------------------------------------------------------
# Remat policy: the predicate over checkpoint names that jit.TrainStep
# arms for its step and the models' per-layer remat sites read
# (framework/remat.py). None (the default) is "save nothing": every
# rematerialised layer recomputes all of its forward in the backward.
# ---------------------------------------------------------------------------

class _RematState(threading.local):
    def __init__(self):
        self.policy = None


_remat_state = _RematState()


def current_remat_policy():
    """The remat predicate armed on this thread (None: save nothing)."""
    return _remat_state.policy


@contextlib.contextmanager
def remat_policy_guard(policy):
    prev = _remat_state.policy
    _remat_state.policy = policy
    try:
        yield
    finally:
        _remat_state.policy = prev
