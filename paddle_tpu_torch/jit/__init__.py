"""`TrainStep` and `resolve_remat_policy` (counterpart of
paddle_tpu/jit/__init__.py).

The reference compiles forward, backward and the optimizer update into
one XLA executable (`_pure_body`, l.604-706). PyTorch runs eagerly, so
the port's step is the same sequence run in order on one device:
`step_fn(*batch)`, `backward()`, `optimizer.step()`, and the grads
dropped (`clear_grad(set_to_zero=False)`, as the compiled body does).
The remat policy is armed around the forward and the backward, as the
reference arms it around its trace (l.708-717); it acts where a model
rematerialises its layers (`cfg.use_recompute`), so the encoders (BERT,
ERNIE), which have no remat site, run the same under every policy.
Dropout draws its masks from the dropout stream
(`framework.core.dropout_generator`) as the forward reaches each
dropout, so each step takes new masks in the forward's order; the
reference folds the step count into one key per step instead, and the
draws cannot match `jax.random`'s either way. Sharding is not ported:
asking for it raises, and so does an unported reference flag set in the
environment (`core.check_env_flags`).

Before its first step `TrainStep` primes the optimizer (l.746-758; the
port's `prime` creates the missing accumulators), and it reads the
learning rate on the host once a step (`last_lr`; l.767). With
`scaler=` a step runs `scaler.scale(loss).backward()`,
`scaler.step(optimizer)` and `scaler.update()` (l.664-668) and returns
the unscaled loss. With `accumulate_steps=k` (l.537-602) it splits every
batch tensor on its leading axis into k micro-batches (an indivisible
batch raises ValueError), runs k forwards and backwards that accumulate
the grads in the parameters' dtype, scales the grads of the parameters
the loss reached by 1/k in that dtype, takes one optimizer step and
returns the mean of the f32 micro-losses; k > 1 with a scaler raises
ValueError, as in the reference. `opt_state_bytes_per_rank()` counts the
optimizer's accumulators and master weights; while observability is
armed the first step sets it as the `train.opt_state_bytes` gauge.

After each step it reads the reference's three step flags (l.797-878):
FLAGS_check_nan_inf raises FloatingPointError on a non-finite loss or
updated floating parameter (the parameters are updated first, as the
reference's compiled step updates them); FLAGS_benchmark prints the
step's wall time in ms on stderr, after a synchronize;
FLAGS_log_memory_stats prints the allocated and peak bytes of the host's
CUDA devices on stderr, through `observability.update_device_memory_gauges`
(which also sets the device.* gauges), and nothing on the CPU (where the
reference's CPU backend reports no memory stats).

While observability is armed, each step runs inside
`observability.device_events.execution("train_step", device)` (host
dispatch wall; device seconds from CUDA events on a card) and closes a
goodput window (`goodput.step_boundary`), as the reference's step does
(l.813-814, 880-884). The reference passes its executable's
cost-analysis FLOPs to the boundary for the MFU gauge; the port has no
FLOP count of its step, so it passes none and the gauge stays unset.
"""
from __future__ import annotations

import sys
import time

import torch

from .. import observability
from ..framework import core, remat
from ..observability import device_events as _devev
from ..observability import goodput as _goodput
from ..observability import metrics as _om

__all__ = ["TrainStep", "resolve_remat_policy"]

_OPT_STATE_BYTES = _om.gauge(
    "train.opt_state_bytes",
    "per-rank optimizer-state bytes of a compiled TrainStep by executable")


def resolve_remat_policy(policy):
    """Map TrainStep's remat_policy= knob onto a predicate over remat
    site names (framework/remat.py; the reference maps it onto a
    jax.checkpoint policy, l.318-349).

    None             -> None: the model's save-nothing default
    "save_matmul_outputs" (the TrainStep default) -> keep the sites
                        named in models.llama.MATMUL_CHECKPOINT_NAMES
                        (llama_qkv, llama_attn_o, llama_swiglu,
                        llama_mlp_down); a model with no such sites
                        saves nothing
    "nothing" / "recompute_all" -> keep no site
    "dots"           -> keep every plain matmul site
                        (models.llama.DOT_CHECKPOINT_NAMES), not the
                        SwiGLU kernel's output
    callable         -> passed through: policy(name) -> bool

    Policies change memory and recompute only, never values.
    """
    if policy is None or callable(policy):
        return policy
    if policy == "save_matmul_outputs":
        from ..models.llama import MATMUL_CHECKPOINT_NAMES
        return frozenset(MATMUL_CHECKPOINT_NAMES).__contains__
    if policy in ("nothing", "recompute_all"):
        return remat.save_nothing
    if policy == "dots":
        from ..models.llama import DOT_CHECKPOINT_NAMES
        return frozenset(DOT_CHECKPOINT_NAMES).__contains__
    raise ValueError(
        f"TrainStep: unknown remat_policy {policy!r} — expected None, "
        f"'save_matmul_outputs', 'nothing', 'recompute_all', 'dots' or a "
        f"callable over remat site names")


class TrainStep:
    """One training step per call: returns the (detached) loss.

    step_fn: callable(*batch) -> scalar loss tensor, calling `model`.
    remat_policy: see `resolve_remat_policy`."""

    def __init__(self, model, optimizer, step_fn, scaler=None, shard=None,
                 accumulate_steps=1, remat_policy="save_matmul_outputs"):
        if shard is not None:
            raise NotImplementedError(
                "TrainStep(shard=...): sharded training is not ported yet")
        self._accum = int(accumulate_steps)
        if self._accum > 1 and scaler is not None:
            raise ValueError(
                "accumulate_steps > 1 is incompatible with a GradScaler: "
                "micro-grads are merged unscaled (bf16 training does not "
                "need loss scaling)")
        core.check_env_flags("TrainStep")
        self._remat_policy = resolve_remat_policy(remat_policy)
        self.model = model
        self.optimizer = optimizer
        self.step_fn = step_fn
        self.scaler = scaler
        self.last_lr = None
        self._opt_state_bytes = None

    def _run(self, batch):
        """One step's forward, backward and update; returns the loss."""
        if self._accum > 1:
            return self._run_accum(batch)
        with core.remat_policy_guard(self._remat_policy):
            loss = self.step_fn(*batch)
            if self.scaler is not None:
                self.scaler.scale(loss).backward()
            else:
                loss.backward()
        if self.scaler is not None:
            self.scaler.step(self.optimizer)
            self.scaler.update()
        else:
            self.optimizer.step()
        return loss

    def _run_accum(self, batch):
        k = self._accum

        def split(x):
            if x.shape[0] % k:
                raise ValueError(
                    f"accumulate_steps={k} must divide the batch leading "
                    f"dim {x.shape[0]}")
            return x.chunk(k)

        params = [p for p in self.optimizer._parameter_list
                  if p.requires_grad]
        for p in params:
            p.grad = None
        # each backward adds into .grad in the parameter's dtype (0 + g1 +
        # g2 ..., the reference's scan carry); a parameter the loss never
        # reaches keeps grad None, and the step skips it
        loss_sum = None
        for mb in zip(*(split(x) for x in batch)):
            with core.remat_policy_guard(self._remat_policy):
                loss = self.step_fn(*mb)
                loss.backward()
            part = loss.detach().float()
            loss_sum = part if loss_sum is None else loss_sum + part
        inv_k = 1.0 / k
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(inv_k)
        self.optimizer.step()
        return loss_sum * inv_k

    def opt_state_bytes_per_rank(self):
        """Bytes of optimizer state (accumulators and amp master weights)
        this process holds: one card holds them all."""
        opt = self.optimizer
        tensors = list(opt._state.values()) + list(
            opt._master_weights.values())
        return sum(t.numel() * t.element_size() for t in tensors)

    def __call__(self, *batch):
        bench = core.get_bool_flag("FLAGS_benchmark")
        t0 = time.perf_counter()
        device = next(self.model.parameters()).device
        opt = self.optimizer
        if self._opt_state_bytes is None:
            opt.prime()
        self.last_lr = opt.get_lr()
        with _devev.execution("train_step", device):
            loss = self._run(batch)
            opt.clear_grad(set_to_zero=False)
        if self._opt_state_bytes is None:
            self._opt_state_bytes = self.opt_state_bytes_per_rank()
            if observability.enabled():
                _OPT_STATE_BYTES.set(self._opt_state_bytes,
                                     executable="train_step")
        n = opt._step_count
        if bench:
            if loss.is_cuda:
                torch.cuda.synchronize(loss.device)
            print(f"TrainStep[{n}]: "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms",
                  file=sys.stderr)
        if core.get_bool_flag("FLAGS_log_memory_stats"):
            # the allocator's readings, mirrored into the registry's
            # device.bytes_in_use / device.peak_bytes_in_use gauges; None
            # with no card, and then nothing is printed
            mem = observability.update_device_memory_gauges()
            if mem is not None:
                print(f"TrainStep[{n}] memory: "
                      f"in_use={mem['bytes_in_use']} "
                      f"peak={mem['peak_bytes_in_use']}", file=sys.stderr)
        if core.get_bool_flag("FLAGS_check_nan_inf"):
            if not bool(torch.isfinite(loss).all()):
                raise FloatingPointError(
                    "NaN or Inf in TrainStep loss (FLAGS_check_nan_inf). "
                    "Rerun the step eagerly (without TrainStep) to get the "
                    "failing op's name.")
            bad = [name for name, p in self.model.named_parameters()
                   if p.is_floating_point()
                   and not bool(torch.isfinite(p).all())]
            if bad:
                raise FloatingPointError(
                    f"NaN or Inf in updated parameters {bad[:5]} "
                    "(FLAGS_check_nan_inf)")
        _goodput.step_boundary()
        return loss.detach()
