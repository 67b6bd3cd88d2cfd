"""Layers of the port (counterpart of paddle_tpu/nn/layer)."""
from .common import (AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                     Dropout3D, LayerNorm, Linear)
from .transformer import MultiHeadAttention  # noqa: F401
