from . import functional  # noqa: F401
from .layer import (  # noqa: F401
    FusedBiasDropoutResidualLayerNorm, FusedDropoutAdd, FusedEcMoe,
    FusedFeedForward, FusedLinear, FusedMultiHeadAttention,
    FusedTransformerEncoderLayer)

__all__ = ["functional", "FusedLinear", "FusedDropoutAdd",
           "FusedBiasDropoutResidualLayerNorm", "FusedMultiHeadAttention",
           "FusedFeedForward", "FusedTransformerEncoderLayer", "FusedEcMoe"]
