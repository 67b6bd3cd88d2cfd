"""Flag registry, seeding, the dropout stream, device resolution and
the armed remat policy (counterpart of paddle_tpu/framework/core.py).

The dropout stream is the counterpart of the reference's `_rng` /
`next_rng_key` (l.203-273): one `torch.Generator` per device, created on
first use from the last `seed(s)` (0 before any), so a seeded run draws
the same dropout masks in the same order. `dropout_generator(device)`
returns it; `nn.functional.dropout` draws from it when the caller passes
no generator. Its state is not saved or restored.

Only the flags the ported slices read are registered, with the
reference's names and defaults; `get_flag` reads the environment
first, as the reference does, and `get_bool_flag` normalises env
strings so `FLAGS_x=0` turns a kill switch off. `set_flags` applies the
reference's side effects of the observability flags the port has:
`FLAGS_fault_inject` re-arms `utils.fault_injection`, `FLAGS_metrics`
arms or disarms `observability.metrics` and `spans`,
`FLAGS_metrics_port` starts, moves or (0) stops the /metrics endpoint,
`FLAGS_flight_recorder` installs or ("") removes the flight recorder,
`FLAGS_span_ring_size` re-bounds the span ring,
`FLAGS_request_trace_sink` points or ("") closes the request-trace
JSONL sink, and `FLAGS_cudnn_deterministic` sets
`torch.backends.cudnn.deterministic` (and turns `cudnn.benchmark` off
while it is on).

Every other flag raises rather than being silently dropped:
`set_flags` refuses a name the port does not register, and
`check_env_flags` (run where `TrainStep` and `ContinuousBatchingEngine`
are built) refuses a reference flag set in the environment to a value
other than the reference's default. `_REFERENCE_FLAGS` is the port's
own copy of the reference's flag table (names and defaults); the port
does not import the reference.
"""
from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["set_flags", "get_flag", "get_bool_flag", "check_env_flags",
           "seed", "dropout_generator", "resolve_device", "convert_dtype",
           "current_remat_policy", "remat_policy_guard"]

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
    # self-speculative decoding (chunked-prefill regime, greedy only):
    # n-gram prompt-lookup drafts of up to FLAGS_speculative_draft_tokens
    # tokens a decode slot, verified as extra rows of the same ragged
    # step; 0 is the kill switch (single-token decode rows)
    "FLAGS_speculative": True,
    "FLAGS_speculative_draft_tokens": 4,
    # the serving SLO layer (priorities, deadlines, the queue bound,
    # shedding, degradation, per-request fault isolation), armed by
    # default as in the reference; 0 is the kill switch (the FIFO engine)
    "FLAGS_serving_slo": True,
    # request tracing (inference/serving.py + observability/reqtrace.py):
    # per-request event timelines and the exact attribution ledger, armed
    # by default as in the reference; 0 leaves the tick loop bitwise as
    # without it. The sink is an append-only JSONL path ("" = the
    # in-memory store only)
    "FLAGS_request_trace": True,
    "FLAGS_request_trace_sink": "",
    # fault-injection schedule (utils/fault_injection.py grammar; "" is
    # disarmed), the metrics registry's and spans' arming, the /metrics
    # endpoint's port (0 = off), the flight recorder's JSONL path ("" =
    # off) and the span ring's bound (observability)
    "FLAGS_fault_inject": "",
    "FLAGS_metrics": False,
    "FLAGS_metrics_port": 0,
    "FLAGS_flight_recorder": "",
    "FLAGS_span_ring_size": 512,
    # read by jit.TrainStep after each step, as the reference's TrainStep
    # reads them (paddle_tpu/jit/__init__.py): a non-finite loss or
    # updated parameter raises FloatingPointError; the step's wall time
    # in ms, and the device's allocated and peak bytes (CUDA only), on
    # stderr
    "FLAGS_check_nan_inf": False,
    "FLAGS_benchmark": False,
    "FLAGS_log_memory_stats": False,
    # deterministic cuDNN algorithms: set_flags sets torch.backends.cudnn.
    # deterministic and turns cudnn.benchmark off while it is on; the
    # conv functionals also read it (set or in the environment) around
    # each of their cuDNN calls (nn/functional/conv.py)
    "FLAGS_cudnn_deterministic": False,
}

# The reference's flag table (paddle_tpu/framework/core.py, `_flags`):
# every name with its default. A name here that `_flags` above does not
# register is not ported: setting it raises (`set_flags`,
# `check_env_flags`). Among them FLAGS_gemm_use_half_precision_compute_type
# (TF32 on or off, ROADMAP Queue 2) and the observability flags not ported
# yet (metrics snapshots and their interval, the lock witness: ROADMAP
# Queue 1 items 9 and 11).
_REFERENCE_FLAGS = {
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_warn_only": False,
    "FLAGS_check_nan_inf_level": 0,
    "FLAGS_call_stack_level": 1,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_cpu_deterministic": False,
    "FLAGS_embedding_deterministic": 0,
    "FLAGS_eager_dispatch_cache": True,
    "FLAGS_eager_dispatch_cache_size": 1024,
    "FLAGS_fault_inject": "",
    "FLAGS_comm_timeout": 1800.0,
    "FLAGS_metrics": False,
    "FLAGS_metrics_port": 0,
    "FLAGS_flight_recorder": "",
    "FLAGS_span_ring_size": 512,
    "FLAGS_metrics_snapshot": "",
    "FLAGS_metrics_snapshot_interval": 2.0,
    "FLAGS_request_trace": True,
    "FLAGS_request_trace_sink": "",
    "FLAGS_lock_witness": False,
    "FLAGS_dataloader_prefetch": True,
    "FLAGS_use_autotune": True,
    "FLAGS_use_fused_ce": False,
    "FLAGS_use_flash_attention": True,
    "FLAGS_fused_transformer": True,
    "FLAGS_ragged_attention": True,
    "FLAGS_serving_slo": True,
    "FLAGS_speculative": True,
    "FLAGS_speculative_draft_tokens": 4,
    "FLAGS_prefix_cache": True,
    "FLAGS_serving_fleet": True,
    "FLAGS_quant_collectives": True,
    "FLAGS_quant_collectives_block": 256,
    "FLAGS_zero": True,
    "FLAGS_cudnn_exhaustive_search": False,
    "FLAGS_gemm_use_half_precision_compute_type": True,
    "FLAGS_benchmark": False,
    "FLAGS_log_memory_stats": False,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_gpu_memory_limit_mb": 0,
    "FLAGS_conv_workspace_size_limit": 512,
    "FLAGS_cudnn_batchnorm_spatial_persistent": False,
    "FLAGS_enable_cublas_tensor_op_math": True,
    "FLAGS_use_system_allocator": False,
    "FLAGS_use_pinned_memory": True,
    "FLAGS_init_allocated_mem": False,
    "FLAGS_initial_cpu_memory_in_mb": 500,
    "FLAGS_memory_fraction_of_eager_deletion": 1.0,
    "FLAGS_fast_eager_deletion_mode": True,
    "FLAGS_use_mkldnn": False,
    "FLAGS_enable_pir_api": True,
    "FLAGS_new_executor_serial_run": False,
    "FLAGS_low_precision_op_list": 0,
    "FLAGS_print_model_stats": False,
    "FLAGS_sync_nccl_allreduce": True,
    "FLAGS_fuse_parameter_memory_size": -1,
    "FLAGS_rpc_deadline": 180000,
    "FLAGS_apply_pass_to_program": False,
}

_FALSY = (False, None, 0, 0.0, "0", "false", "False", "", "off", "OFF")


def _not_ported(key) -> str:
    where = ("a flag of the reference" if key in _REFERENCE_FLAGS
             else "not a flag of the reference either")
    return (f"{key} is not ported ({where}); the port's flags are "
            f"{', '.join(sorted(_flags))}")


# cudnn.benchmark as it was when FLAGS_cudnn_deterministic turned it off
_benchmark_before = False


def _apply_flag(key, value) -> None:
    """The reference's side effects of the flags that steer a global
    subsystem (paddle_tpu/framework/core.py `_apply_flag`)."""
    if key == "FLAGS_fault_inject":
        from ..utils import fault_injection
        fault_injection.configure(value if isinstance(value, str) else None)
    elif key == "FLAGS_metrics":
        from .. import observability
        observability.enable(value not in _FALSY)
    elif key == "FLAGS_metrics_port":
        from ..observability import export as _oexp
        _oexp.serve_metrics(int(value or 0))
    elif key == "FLAGS_flight_recorder":
        from ..observability import export as _oexp
        if value:
            _oexp.install_flight_recorder(str(value))
        else:
            _oexp.uninstall_flight_recorder()
    elif key == "FLAGS_span_ring_size":
        from ..observability import spans as _ospans
        _ospans.set_ring_size(int(value))
    elif key == "FLAGS_request_trace_sink":
        from ..observability import reqtrace as _ortrace
        _ortrace.set_sink(str(value) if value else None)
    elif key == "FLAGS_cudnn_deterministic":
        global _benchmark_before
        cd = torch.backends.cudnn
        if value not in _FALSY:
            if not cd.deterministic:
                _benchmark_before = cd.benchmark
            cd.deterministic, cd.benchmark = True, False
        elif cd.deterministic:
            cd.deterministic, cd.benchmark = False, _benchmark_before


def set_flags(flags: dict) -> None:
    """Set registered flags; a name the port does not register raises
    NotImplementedError and nothing is set."""
    for k in flags:
        if k not in _flags:
            raise NotImplementedError(f"set_flags: {_not_ported(k)}")
    for k, v in flags.items():
        _flags[k] = v
        _apply_flag(k, v)


def _is_default(env: str, default) -> bool:
    """Whether an environment string states the reference's default."""
    if isinstance(default, bool):
        return (env not in _FALSY) == default
    if isinstance(default, (int, float)):
        try:
            return float(env) == float(default)
        except ValueError:
            return False
    return env == default


def check_env_flags(what: str) -> None:
    """Raise NotImplementedError when the environment sets a reference
    flag the port does not port to a value other than the reference's
    default: the reference would act on it, the port cannot. `what`
    names the entry point in the message. Names that are no flag of the
    reference are left alone, as the reference leaves them."""
    for key, env in os.environ.items():
        if key in _flags or key not in _REFERENCE_FLAGS:
            continue
        if not _is_default(env, _REFERENCE_FLAGS[key]):
            raise NotImplementedError(
                f"{what}: {key}={env!r} in the environment: "
                f"{_not_ported(key)}")


def get_flag(key, default=None):
    env = os.environ.get(key)
    if env is not None:
        return env
    return _flags.get(key, default)


def get_bool_flag(key, default=False) -> bool:
    """Boolean view of a flag: env-set flags arrive as strings, so
    bool('0') would invert every kill switch — normalise here."""
    return get_flag(key, default) not in _FALSY


# the dropout stream: the seed of the last `seed(s)` and one generator
# per device, made from it on first use
_dropout_seed = 0
_dropout_gens: dict = {}
_dropout_lock = threading.Lock()


def seed(s: int) -> torch.Generator:
    """Seed torch's global generators (CPU and every CUDA device) and the
    dropout stream, and return a CPU `torch.Generator` seeded with `s`.
    Code that samples takes an explicit generator; this is for callers
    that want one."""
    global _dropout_seed
    torch.manual_seed(int(s))
    with _dropout_lock:
        _dropout_seed = int(s)
        _dropout_gens.clear()
    g = torch.Generator()
    g.manual_seed(int(s))
    return g


def dropout_generator(device) -> torch.Generator:
    """The dropout stream's generator on `device`: made from the last
    `seed(s)` (0 before any) on first use, then advanced by each draw."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _dropout_lock:
        g = _dropout_gens.get(dev)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_dropout_seed)
            _dropout_gens[dev] = g
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


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def convert_dtype(dtype, default=torch.float32) -> torch.dtype:
    """A torch dtype from a paddle name ("float32", "bfloat16", ...), a
    torch dtype, or None (`default`)."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "").replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}")
    return _DTYPES[name]


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
