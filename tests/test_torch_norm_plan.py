"""rms_norm's kernel plan and its two host routes, on the CPU.

`paddle_tpu_torch.kernels.rms_norm.plan` is the pure-Python geometry the
wrapper hands the CUDA kernel (csrc/rms_norm.cu): it must cover every row
exactly once through the kernel's persistent walk, every 16-byte vector
of a row exactly once through its lanes, and stay within what one H100
SM holds. The wrapper's lean route (no autograd Function, taken where no
gradient is wanted) and its autograd route must agree with each other
and with the JAX package's `rms_norm` and `_rms_bwd` on seeded numpy
inputs; CPU tensors run the plain version and never count a launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import rms_norm as j_rms
from paddle_tpu_torch.kernels import rms_norm as t_rms

from _torch_threads import one_torch_thread  # noqa: F401,E402

# the kernel phase's row counts (chip_smoke.py) and the plan's edges
ROWS = [128, 4, 8192, 32, 512, 2048, 1, 3, 37, 129, 8191]
WIDTHS = [256, 2048, 4096, 5120, "max"]
SM_THREADS = 2048           # an H100 SM's resident threads
SM_SMEM = 228 * 1024        # and its shared memory


def _walk(p, rows):
    """The rows the kernel's blocks visit, in the kernel's own loop: block
    b takes row groups b, b + grid, ... of rpb rows each."""
    seen = []
    for blk in range(p.grid):
        g = blk
        while g * p.rpb < rows:
            seen += [r for r in range(g * p.rpb, (g + 1) * p.rpb)
                     if r < rows]
            g += p.grid
    return seen


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("H", WIDTHS)
def test_plan_covers_rows_and_vectors_within_the_card(dtype, H):
    if H == "max":
        H = t_rms._MAX_ROW_BYTES // (torch.finfo(dtype).bits // 8)
    assert t_rms.supported((1, H), dtype)
    nvec = H * (torch.finfo(dtype).bits // 8) // 16
    for rows in ROWS:
        p = t_rms.plan(rows, H, dtype)
        tpr = 32 * p.wpr
        assert p.vpt in (1, 2, 4)
        assert p.threads == tpr * p.rpb <= 1024
        # each vector of a row by exactly one lane
        owned = sorted(t + i * tpr for t in range(tpr) for i in range(p.vpt)
                       if t + i * tpr < nvec)
        assert owned == list(range(nvec)), (rows, H)
        # each row by exactly one block, once
        seen = _walk(p, rows)
        assert sorted(seen) == list(range(rows)), (rows, H)
        # within the card: the grid is resident at once
        assert 1 <= p.grid <= t_rms.SMS * p.per_sm
        assert p.per_sm * p.threads <= SM_THREADS
        assert p.per_sm * p.smem <= SM_SMEM and p.smem <= 48 * 1024


def test_plan_spreads_few_rows_and_packs_many():
    """Decode's 4 rows of 4096 bf16 take 16 warps a row, one vector a
    lane; the training slices' 8192 rows take the fewest warps that keep
    a lane at 4 vectors, in blocks of 8 warps, 3 on each of the card's 132
    SMs."""
    p = t_rms.plan(4, 4096, torch.bfloat16)
    assert (p.wpr, p.vpt, p.grid) == (16, 1, 4)
    p = t_rms.plan(8192, 4096, torch.bfloat16)
    assert (p.wpr, p.rpb, p.vpt, p.grid) == (4, 2, 4, 396)
    p = t_rms.plan(8192, 2048, torch.bfloat16)
    assert (p.wpr, p.rpb, p.vpt, p.grid) == (2, 4, 4, 396)


def test_supported_takes_at_least_the_first_designs_shapes():
    """Every shape the first design took (H % 8 == 0 and H * itemsize <=
    48 KB) is still taken; odd widths and other dtypes are not."""
    for dt, it in ((torch.bfloat16, 2), (torch.float32, 4)):
        for H in range(8, 48 * 1024 // it + 1, 8):
            assert t_rms.supported((3, H), dt), (dt, H)
        assert not t_rms.supported((3, 12), dt)
    assert not t_rms.supported((3, 64), torch.float16)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 5, 256).astype(np.float32)
    w = (1 + 0.1 * rng.randn(256)).astype(np.float32)
    g = rng.randn(3, 5, 256).astype(np.float32)
    return x, w, g


def _jax_ref(x, w, g, eps):
    y, vjp = jax.vjp(lambda a, b: j_rms.rms_norm(a, b, eps),
                     jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), np.asarray(dw)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode", "grad"])
def test_routes_match_jax(mode, monkeypatch):
    """The same output (and, in grad mode, the same gradients) on every
    route, against the JAX package's rms_norm and its custom VJP
    (`_rms_bwd`); no_grad and inference_mode take the lean route (the
    autograd Function is never entered), grad mode the Function."""
    x, w, g = _inputs()
    eps = 1e-5
    y_j, dx_j, dw_j = _jax_ref(x, w, g, eps)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    entered = []
    apply = t_rms._RmsNorm.apply
    monkeypatch.setattr(t_rms._RmsNorm, "apply",
                        lambda *a: entered.append(1) or apply(*a))
    launches = t_rms.rms_norm.launches
    if mode == "grad":
        y = t_rms.rms_norm(xt, wt, eps)
        y.backward(torch.from_numpy(g))
        assert entered and y.grad_fn is not None
        assert _max_rel(xt.grad.numpy(), dx_j) <= 1e-6
        assert _max_rel(wt.grad.numpy(), dw_j) <= 1e-6
    else:
        ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
        with ctx:
            y = t_rms.rms_norm(xt, wt, eps)
        assert not entered and y.grad_fn is None and not y.requires_grad
    assert _max_rel(y.detach().numpy(), y_j) <= 1e-6
    assert t_rms.rms_norm.launches == launches == 0


def test_grad_mode_without_grad_inputs_is_lean(monkeypatch):
    """Grad mode on, but neither input requires grad: the lean route."""
    x, w, _ = _inputs(1)
    monkeypatch.setattr(t_rms._RmsNorm, "apply",
                        lambda *a: pytest.fail("autograd route entered"))
    y = t_rms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    want = np.asarray(j_rms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    assert _max_rel(y.numpy(), want) <= 1e-6
