"""Layers of the port (counterpart of paddle_tpu/nn/layer)."""
from .common import LayerNorm, Linear  # noqa: F401
from .transformer import MultiHeadAttention  # noqa: F401
