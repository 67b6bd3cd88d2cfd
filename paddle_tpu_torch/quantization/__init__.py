"""Quantization (counterpart of paddle_tpu/quantization/): only the
per-channel int8 rule of weight-only serving (`comm`) is ported; the
QAT/PTQ surface and the blockwise wire plumbing of the quantized
collectives are not."""
from . import comm  # noqa: F401
from .comm import channelwise_absmax_int8, dequantize_channelwise  # noqa: F401

__all__ = ["comm", "channelwise_absmax_int8", "dequantize_channelwise"]
