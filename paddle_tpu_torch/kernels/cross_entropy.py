"""Fused softmax cross-entropy for large vocabularies (counterpart of
paddle_tpu/kernels/cross_entropy.py).

`fused_cross_entropy(logits [N, V], labels [N], ignore_index)` returns
the per-row loss in f32 without an f32 [N, V] log-softmax ever existing:
the forward keeps the running max m and sum-exp l of each row and the
logit at its label, loss = log l + m - x[label] (0 on ignore_index
rows; a label outside [0, V) that is not ignore_index reads no logit,
loss = log l + m, as the reference's one-hot never hits); the backward
recomputes dx = (exp(x - m) / l - onehot) * g * valid from the saved
(m, l) and writes it in the logits' dtype.

A CUDA tensor runs a `torch.autograd.Function` over the hand-written
kernels in `csrc/cross_entropy.cu` (`fused_cross_entropy_fwd`, one
launch, and `fused_cross_entropy_bwd`, one launch); it saves (logits,
labels, m, l). A CPU tensor runs the same Function over `_plain_fwd` and
`_plain_bwd`, the reference's arithmetic in f32 over whole rows. A CUDA
tensor the kernels cannot take raises; nothing falls back.
"""
from __future__ import annotations

import torch

from ..framework import core
from . import _build

__all__ = ["fused_cross_entropy", "fused_cross_entropy_fwd",
           "fused_cross_entropy_bwd", "supported", "kernel_takes"]


def supported(n_classes: int, min_vocab: int = 4096, device="cuda") -> bool:
    """The reference's gate (cross_entropy.py:40-51): worth routing
    through the kernels when FLAGS_use_fused_ce is on, the vocabulary has
    at least `min_vocab` classes and the logits lie on the card (the
    reference asks for the TPU backend). FLAGS_use_fused_ce=0, the
    default, keeps the plain f32 log-softmax route."""
    return (core.get_bool_flag("FLAGS_use_fused_ce", False)
            and torch.device(device).type == "cuda"
            and int(n_classes) >= min_vocab)


def kernel_takes(logits, labels) -> bool:
    """What the kernels take: logits [N, V] in bf16 or f32, labels [N]
    in int32 or int64, on one device."""
    return (logits.dim() == 2 and labels.dim() == 1
            and labels.shape[0] == logits.shape[0] and logits.shape[1] > 0
            and logits.dtype in (torch.bfloat16, torch.float32)
            and labels.dtype in (torch.int32, torch.int64)
            and labels.device == logits.device)


def _label_logit(x, lbl):
    """x[i, lbl[i]] where 0 <= lbl[i] < V, else 0."""
    V = x.shape[1]
    inb = (lbl >= 0) & (lbl < V)
    picked = torch.gather(x, 1, torch.where(inb, lbl, 0)[:, None])[:, 0]
    return torch.where(inb, picked, torch.zeros_like(picked))


def _plain_fwd(logits, labels, ignore_index):
    """(loss, m, l), each f32 [N], over whole rows in f32."""
    x = logits.float()
    lbl = labels.long()
    m = x.max(dim=1).values
    l = torch.exp(x - m[:, None]).sum(dim=1)
    loss = torch.log(l) + m - _label_logit(x, lbl)
    return torch.where(lbl != ignore_index, loss,
                       torch.zeros_like(loss)), m, l


def _plain_bwd(logits, labels, m, l, g, ignore_index):
    """dx = (exp(x - m) / l - onehot) * g * valid, f32 [N, V]."""
    x = logits.float()
    lbl = labels.long()
    p = torch.exp(x - m[:, None]) / l[:, None]
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols[None, :] == lbl[:, None]).float()
    gv = g.float() * (lbl != ignore_index).float()
    return (p - onehot) * gv[:, None]


def _plain(logits, labels, ignore_index=-100):
    """The per-row loss as one differentiable f32 expression (autograd
    gives `_plain_bwd`'s dx): the comparison route of chip_smoke.py."""
    x = logits.float()
    lbl = labels.long()
    m = x.max(dim=1).values.detach()
    loss = (torch.log(torch.exp(x - m[:, None]).sum(dim=1)) + m
            - _label_logit(x, lbl))
    return torch.where(lbl != ignore_index, loss, torch.zeros_like(loss))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(lib, name, dtype):
    return getattr(lib, f"{name}_{'bf16' if dtype == torch.bfloat16 else 'f32'}")


def _rows(t):
    """Contiguous with a 16-byte aligned base: the kernels read rows in
    16-byte vectors from each row's first aligned element, so the logits
    and dx (allocated aligned) must share their rows' alignment."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def fused_cross_entropy_fwd(logits, labels, ignore_index=-100):
    """Kernel route, forward: logits [N, V], labels [N] int32/int64 ->
    (loss, m, l), each f32 [N]."""
    N, V = logits.shape
    x = _rows(logits)
    lbl = labels.contiguous()
    loss = torch.empty((N,), dtype=torch.float32, device=x.device)
    m = torch.empty_like(loss)
    l = torch.empty_like(loss)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(_fn(lib, "ptt_cross_entropy_fwd", x.dtype)(
            x.data_ptr(), lbl.data_ptr(), int(lbl.dtype == torch.int64),
            loss.data_ptr(), m.data_ptr(), l.data_ptr(), N, V,
            int(ignore_index), _stream(x)), "fused_cross_entropy_fwd")
    fused_cross_entropy_fwd.launches += 1
    return loss, m, l


def fused_cross_entropy_bwd(logits, labels, m, l, g, ignore_index=-100):
    """Kernel route, backward: the forward's logits, labels, m and l and
    the per-row cotangent g [N] -> dx [N, V] in the logits' dtype."""
    N, V = logits.shape
    x = _rows(logits)
    lbl = labels.contiguous()
    g = g.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        _build.check(_fn(lib, "ptt_cross_entropy_bwd", x.dtype)(
            x.data_ptr(), lbl.data_ptr(), int(lbl.dtype == torch.int64),
            m.contiguous().data_ptr(), l.contiguous().data_ptr(),
            g.data_ptr(), dx.data_ptr(), N, V, int(ignore_index),
            _stream(x)), "fused_cross_entropy_bwd")
    fused_cross_entropy_bwd.launches += 1
    return dx


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        if logits.device.type == "cpu":
            loss, m, l = _plain_fwd(logits, labels, ignore_index)
        else:
            loss, m, l = fused_cross_entropy_fwd(logits, labels, ignore_index)
        ctx.save_for_backward(logits, labels, m, l)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, m, l = ctx.saved_tensors
        if logits.device.type == "cpu":
            dx = _plain_bwd(logits, labels, m, l, g,
                            ctx.ignore_index).to(logits.dtype)
        else:
            dx = fused_cross_entropy_bwd(logits, labels, m, l, g,
                                         ctx.ignore_index)
        return dx, None, None


def fused_cross_entropy(logits, labels, ignore_index=-100, use_kernel=None):
    """Per-row CE loss [N] f32 from logits [N, V] and labels [N] int;
    ignore_index rows give 0 (the caller divides by the valid count).

    use_kernel=None routes by device (kernels on CUDA, plain on CPU);
    True demands the kernels and raises ValueError for a CPU tensor or a
    shape/dtype they do not take."""
    ok = kernel_takes(logits, labels)
    if use_kernel and not ok:
        raise ValueError(
            f"fused_cross_entropy: use_kernel=True but the kernels do not "
            f"take logits {tuple(logits.shape)} {logits.dtype}, labels "
            f"{tuple(labels.shape)} {labels.dtype} (need logits [N, V] in "
            f"bf16/f32 and labels [N] int32/int64 on the same device)")
    if logits.device.type == "cpu":
        if use_kernel:
            raise ValueError(
                "fused_cross_entropy: use_kernel=True needs a CUDA tensor")
    elif not ok:
        raise ValueError(
            f"fused_cross_entropy: no kernel for logits "
            f"{tuple(logits.shape)} {logits.dtype}, labels "
            f"{tuple(labels.shape)} {labels.dtype}")
    return _FusedCrossEntropy.apply(logits, labels, int(ignore_index))


fused_cross_entropy_fwd.launches = 0
fused_cross_entropy_bwd.launches = 0
