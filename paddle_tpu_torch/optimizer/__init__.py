"""The port's optimizers and LR schedulers (counterpart of
paddle_tpu/optimizer)."""
from . import lr  # noqa: F401
from .optimizer import (  # noqa: F401
    ASGD, LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum,
    Optimizer, RMSProp, Rprop,
)
