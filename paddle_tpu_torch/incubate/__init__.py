"""paddle.incubate (counterpart of paddle_tpu/incubate/): the fused
functionals and layers of `incubate.nn`. Not ported yet, and raising
NotImplementedError when asked for: `incubate.asp` (2:4 sparsity),
`incubate.autograd` (functional jvp/vjp/Hessian) and
`incubate.distributed` (the MoE layer, `distributed.models.moe`)."""
from . import nn  # noqa: F401

__all__ = ["nn"]

_NOT_PORTED = ("asp", "autograd", "distributed")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"incubate.{name} is not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
