"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (sm_90a).

The JAX package `paddle_tpu` is the reference; this package keeps its
module and function names so each counterpart is easy to find, and
never imports `jax` or `paddle_tpu`. Every Pallas kernel on a ported
path is a hand-written CUDA kernel under `csrc/`, built on first use by
`kernels/_build.py`, with a plain PyTorch version beside it that CPU
tensors take.

Ported so far: the serving slice (framework.core flags, the RMSNorm,
SwiGLU and ragged paged attention kernels, the LLaMA serving step over
the paged KV pool, the chunked-prefill continuous-batching engine with
the prefix cache, the HTTP gateway + `serve` CLI) and the training
slice (the LLaMA training forward and loss, `nn.functional.
cross_entropy`, `optimizer.AdamW`, `jit.TrainStep`, and the SwiGLU
backward, fused add+RMSNorm and flash attention forward/backward
kernels), decode (`generate`, the bucketed engine, paged decode
attention), 7B pretraining (remat, the fused cross-entropy kernels), and
BERT inference with the attention surface (`models.bert`,
`nn.functional` attention, `nn.layer.MultiHeadAttention`, the
segment-id flash and block-stats kernels), self-speculative decoding,
and the serving SLO layer armed by default (priorities, deadlines, the
queue bound, shedding, degradation, per-request fault isolation) with
`utils.fault_injection`, `observability` (the metrics and health
registries) and `distributed.watchdog`, request tracing and the
serving telemetry, and encoder training (`models.ernie`, BERT's training
route, the dropout functionals and layers drawn from the dropout stream
of `framework.core`), and the optimizer surface (`optimizer`'s twelve
optimizers and `optimizer.lr`'s schedulers, `nn.clip`, `regularizer`,
`amp.decorate` O2 with f32 master weights, `amp.GradScaler`, and
`jit.TrainStep(scaler=, accumulate_steps=)`), and the nn core with the
Transformer stack (`nn.Layer`, `nn.ParamAttr`, `nn.initializer`, the
containers, activations, norms, losses, `nn.Transformer` and its layers,
`nn.BeamSearchDecoder` / `nn.dynamic_decode`, `sparse_attention`), and
the conv slice (`nn.functional` conv, pooling, `interpolate`, `pad`,
`grid_sample` and the rest of the image functionals, their layers,
`vision.models`' ResNet family and `models.unet`'s SD UNet).

Entry points run on `cuda` unless the caller passes `device="cpu"`;
with no card and no explicit CPU request they raise.
"""
from .framework.core import (get_bool_flag, get_flag,  # noqa: F401
                             resolve_device, seed, set_flags)
from . import amp, regularizer  # noqa: F401,E402

__all__ = ["amp", "get_bool_flag", "get_flag", "regularizer",
           "resolve_device", "seed", "set_flags"]
