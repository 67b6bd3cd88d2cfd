"""Per-layer rematerialisation under a policy over checkpoint names (the
counterpart of the reference's `jax.checkpoint` per decoder layer,
models/llama.py:301-362, with `checkpoint_name` stamps and
`save_only_these_names`, jit/__init__.py:318-349).

`checkpoint(fn, x, policy)` runs `fn(x)` under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: every tensor
the region saves for its backward is dropped and recomputed by running
`fn` again when the backward first needs one, and only the region's
input `x` stays alive. `policy(name) -> bool` is a predicate over the
names of the region's *sites*; a site's output that the policy keeps is
held from the forward and handed back to the recompute, which then does
not compute it again.

Why sites and not a dispatch-level selective checkpoint: the port's
kernels launch through ctypes inside `torch.autograd.Function`s, below
anything `torch.utils.checkpoint.create_selective_checkpoint_contexts`
can see, so a policy there could neither keep a kernel's output nor
skip its launch. A site is instead a call `site(name, fn, *args)` where
`fn(*args, out=None)` is an autograd.Function wrapper that saves the
same tensors for its backward whether it computes its output or is
given it as `out`: the checkpoint's recompute regenerates the saved
tensors (a matmul's input, say) without redoing the product. The
sites are the reference's stamps: `llama_qkv` (`kernels/rope.py`),
`llama_attn_o`, `llama_swiglu` and `llama_mlp_down`, and every other
matmul of a decoder layer under a name of its own
(`models.llama.DOT_CHECKPOINT_NAMES`).

What a policy keeps per layer, beside the layer input:
- None, "nothing", "recompute_all": nothing; the backward recomputes
  the whole layer forward.
- "save_matmul_outputs": `models.llama.MATMUL_CHECKPOINT_NAMES`, the
  qkv projection, the attention's o projection, the SwiGLU kernel's
  output and the down projection; the recompute runs the norms, rope
  and the flash forward only.
- "dots": every plain matmul output of the layer, but not the SwiGLU
  kernel's (a fused kernel, not a matmul), which is recomputed.
- a callable: that predicate.
Policies move memory and recompute, never values: the recompute runs
the same kernels on the same inputs, so loss and grads are bitwise
those of a run without remat.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import checkpoint as _ckpt

from ..kernels import weight_only_linear as _kwol

__all__ = ["checkpoint", "site", "matmul", "save_nothing"]


class _State(threading.local):
    def __init__(self):
        self.frame = None


_state = _State()


class _Frame:
    """One checkpointed region: the policy it was run under and the
    outputs of the sites it keeps, in call order. The forward appends;
    the recompute (on whatever thread runs the backward) takes each back
    once and drops its reference."""

    def __init__(self, policy):
        self.policy = policy
        self.kept = []
        self.replay = False
        self.i = 0

    @contextlib.contextmanager
    def _active(self, replay):
        prev = _state.frame
        _state.frame, self.replay, self.i = self, replay, 0
        try:
            yield
        finally:
            _state.frame = prev

    def contexts(self):
        return self._active(False), self._active(True)


def save_nothing(name):
    """The policy that keeps no site: the whole layer recomputes."""
    return False


def checkpoint(fn, x, policy=None):
    """fn(x) with its saved tensors rematerialised in the backward, the
    outputs of the sites `policy` keeps held instead (policy None: keep
    none)."""
    frame = _Frame(policy or save_nothing)
    # the decoder layers draw no random numbers: no RNG state to replay
    return _ckpt.checkpoint(fn, x, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=frame.contexts)


def site(name, fn, *args):
    """fn(*args) at a named site of the active checkpoint region: its
    output is kept when the region's policy keeps `name`, and handed
    back to the recompute as `fn(*args, out=kept)`. Outside a region
    this is fn(*args)."""
    frame = _state.frame
    if frame is None or not frame.policy(name):
        return fn(*args)
    if frame.replay:
        out = frame.kept[frame.i] if frame.i < len(frame.kept) else None
        if out is not None:
            frame.kept[frame.i] = None
        frame.i += 1
        # a second recompute of the same region (a retained graph) finds
        # nothing kept and computes the output again
        return fn(*args) if out is None else fn(*args, out=out)
    y = fn(*args)
    frame.kept.append(y.detach())
    return y


class _Matmul(torch.autograd.Function):
    """a [..., K] @ w [K, N], saving (a, w) whether it computes the
    product or is given it as `out`."""

    @staticmethod
    def forward(ctx, a, w, out):
        ctx.save_for_backward(a, w)
        return a @ w if out is None else out

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = (g2 @ w.t()).reshape(a.shape)
        if ctx.needs_input_grad[1]:
            dw = a.reshape(-1, a.shape[-1]).t() @ g2
        return da, dw, None


def _matmul(a, w, out=None):
    return _Matmul.apply(a, w, out)


def matmul(a, w, name):
    """a @ w at the site `name`. Without autograd (serving, eval) it is
    the plain product, or the W8A16 kernel for an int8 serving weight
    (`kernels.weight_only_linear.matmul`); with it, one autograd.Function
    whether or not a region is active, so a run with remat and one
    without go through the same backward."""
    if not torch.is_grad_enabled():
        return _kwol.matmul(a, w)
    return site(name, _matmul, a, w)

