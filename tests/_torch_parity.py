"""Shared helpers of the conv-slice parity tests (tests/test_torch_conv.py,
test_torch_pool.py, test_torch_vision_ops.py, test_torch_resnet.py,
test_torch_unet.py): the same seeded numpy arrays go through the JAX
package and the port, forward and backward under one random cotangent,
compared as max|port - reference| / max|reference|."""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu_torch.models.convert import layer_state_from_jax


def t_(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def j_(a, grad=False):
    return paddle.to_tensor(np.array(a, np.float32), stop_gradient=not grad)


def max_rel(got, want):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def carry(jl, tl):
    """The reference layer's state dict (numpy) into the port's layer;
    the keys must come in the same order."""
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(state) == list(tl.state_dict()), "state-dict key order"
    return layer_state_from_jax(state, tl)


def both(j_fn, t_fn, inputs, rng, rtol, grad=True):
    """Forward of both packages on the same inputs, then each input's
    grad under one random cotangent; every pair within rtol. -> the
    port's output."""
    jx = [j_(a, grad) for a in inputs]
    tx = [t_(a, grad) for a in inputs]
    yj, yt = j_fn(*jx), t_fn(*tx)
    err = max_rel(yt, yj.numpy())
    assert err <= rtol, f"forward {err:.3g} > {rtol:g}"
    if grad:
        g = rand(rng, *yt.shape)
        (yj * j_(g)).sum().backward()
        (yt * t_(g)).sum().backward()
        for i, (a, b) in enumerate(zip(tx, jx)):
            err = max_rel(a.grad, b.grad.numpy())
            assert err <= rtol, f"grad of input {i}: {err:.3g} > {rtol:g}"
    return yt
