"""Kernels of the port. Each module holds a wrapper that launches a
hand-written CUDA kernel (`paddle_tpu_torch/csrc/`) for CUDA tensors, the
plain PyTorch version of the same function for CPU tensors, and a
`launches` counter on the wrapper. Modules import no CUDA toolchain at
import time; the kernel library builds on first launch (`_build.py`)."""
