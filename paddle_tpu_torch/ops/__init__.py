"""Tensor operations (counterpart of paddle_tpu/ops). Only
`manipulation.pad` is ported; the rest of the reference's op surface is
ROADMAP Queue 1 item 15."""
