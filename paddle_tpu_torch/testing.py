"""The element limits that hold the port's kernels against their plain
PyTorch versions: one rule, shared by chip_smoke.py and the card tests.

The plain version runs on f32 copies of the kernel's inputs and keeps
its f32 result. An output element passes when

    |kernel - plain| <= atol + rtol * |plain|

(`worst` returns the largest ratio of the two sides; a non-finite kernel
value is a miss). A bf16 kernel that keeps f32 inside and rounds its
result once gets rtol = BF16_RTOL (two roundoffs of 2^-8) and a small
absolute atol for the f32 summation order near zero.

A kernel that rounds an intermediate to the input dtype before a second
product (flash attention's P and dS, the SwiGLU backward's dg and du)
can miss by a roundoff of each term of its sum, not of the sum. Its atol
is element by element: TERM_FRAC[dtype] times that element's own sum of
|terms|, which `flash_terms` and `swiglu_bwd_terms` compute on the plain
side. A limit scaled by the largest |plain| of the whole tensor would be
as large as a typical element of causal attention (the first rows and
keys dominate the maximum) and would pass a kernel that drops or adds a
tile of terms.
"""
from __future__ import annotations

import math

import torch

__all__ = ["BF16_RTOL", "TERM_FRAC", "worst", "flash_terms",
           "flash_pairs", "flash_readings", "swiglu_bwd_terms",
           "swiglu_bwd_pairs"]

BF16_RTOL = 2.0 ** -7
# share of an element's sum of |terms|: two bf16 roundoffs (the rounded
# intermediate and the rounded result); f32 runs no rounded intermediate,
# its share covers the summation order alone
TERM_FRAC = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def worst(out, ref, atol, rtol) -> float:
    """max |out - ref| / (atol + rtol * |ref|) over the elements; atol is
    a number or a tensor shaped like ref. inf when out holds a non-finite
    value."""
    out = out.double()
    ref = ref.double()
    if not bool(torch.isfinite(out).all()):
        return math.inf
    atol = atol.double() if torch.is_tensor(atol) else atol
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _group_sum(t, group):
    """[B, Hq, S, D] -> [B, Hq / group, S, D], summing each kv head's
    group of q heads."""
    if group == 1:
        return t
    B, H, S, D = t.shape
    return t.view(B, H // group, group, S, D).sum(2)


def flash_terms(q, k, v, do, causal, scale=None):
    """f32 sums of |terms| of flash attention's outputs, BSHD like them:
    (o, dq, dk, dv). q, k, v, do are the plain side's f32 copies, GQA
    kv heads not repeated; scale multiplies the scores (None: 1/sqrt(D)).

    o_i = sum_j P_ij v_j, so its terms are P |V|. dS_ij = P_ij (dP_ij -
    D_i) with D_i = sum_d dO_id O_id, so dS's terms are P (|dP| + sum_d
    |dO O|); dq's are |dS| |K| |scale|, dk's |dS|^T |Q| |scale|, dv's
    P^T |dO|, dk and dv summed over a kv head's group of q heads."""
    from .kernels import flash_attention as kfa
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = q.shape[2] // k.shape[2]
    p = torch.softmax(kfa._scores(q, k, causal, scale), dim=-1)
    qh, kh, vh, doh = (t.transpose(1, 2).float() for t in (q, k, v, do))
    if group > 1:
        kh, vh = (t.repeat_interleave(group, dim=1) for t in (kh, vh))
    o = p @ vh
    o_t = p @ vh.abs()
    d_abs = (doh.abs() * o.abs()).sum(-1, keepdim=True)
    ds_t = p * ((doh @ vh.transpose(-1, -2)).abs() + d_abs)
    del o, d_abs
    dq_t = (ds_t @ kh.abs()) * abs(scale)
    dk_t = _group_sum(ds_t.transpose(-1, -2) @ qh.abs(), group) * abs(scale)
    dv_t = _group_sum(p.transpose(-1, -2) @ doh.abs(), group)
    return tuple(t.transpose(1, 2) for t in (o_t, dq_t, dk_t, dv_t))


def flash_pairs(q, k, v, do, causal, scale):
    """The flash kernels (`flash_attention_fwd`, `flash_attention_bwd`)
    and their plain version on the same inputs: q, k, v, do BSHD in one
    dtype; GQA callers pass q pre-scaled in its dtype and scale 1, as
    `flash_attention_bshd` does. Returns ([(label, kernel, plain, terms
    or None)] for o, lse, dq, dk, dv; the kernel's (o, lse))."""
    from .kernels import flash_attention as kfa
    o, lse = kfa.flash_attention_fwd(q, k, v, causal, scale)
    dq, dk, dv = kfa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        o_p = kfa._plain(*ref, causal, scale)
        o_p.backward(do.float())
    plain = [t.detach() for t in ref]
    lse_p = kfa._plain_lse(plain[0], plain[1], causal, scale)
    o_t, dq_t, dk_t, dv_t = flash_terms(*plain, do.float(), causal, scale)
    return ([("o", o, o_p.detach(), o_t), ("lse", lse, lse_p, None),
             ("dq", dq, ref[0].grad, dq_t), ("dk", dk, ref[1].grad, dk_t),
             ("dv", dv, ref[2].grad, dv_t)], (o, lse))


def flash_readings(B=4, S=2048, H=16, D=128, causal=True, seed=0):
    """bf16 MHA flash at the training slice's shape on the card: for each
    output, the worst err/limit under the element limit (`terms`: atol =
    2^-7 of the element's sum of |terms|; lse: 1e-4 + 1e-5 |plain|) and,
    beside it, under a limit scaled by the tensor's max |plain| (`max`:
    atol = 2^-7 max|plain|), both with rtol 2^-7. A reading above 1 is a
    miss."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(4))
    pairs, _ = flash_pairs(q, k, v, do, causal, 1.0 / math.sqrt(D))
    frac = TERM_FRAC[torch.bfloat16]
    out = {}
    for label, got, ref, terms in pairs:
        if terms is None:
            out[label] = {"terms": worst(got, ref, 1e-4, 1e-5)}
            continue
        out[label] = {
            "terms": worst(got, ref, frac * terms, BF16_RTOL),
            "max": worst(got, ref, frac * ref.abs().max().item(), BF16_RTOL)}
    return out


def swiglu_bwd_terms(a, w_gate_up, do):
    """f32 sums of |terms| of the SwiGLU backward's outputs (da, dw) from
    the plain side's f32 copies: dgu = [dg | du] is formed in f32 and
    rounded before both products, da = dgu w_gate_up^T and dw = a^T dgu,
    so the terms are |dgu| |w_gate_up|^T and |a|^T |dgu|."""
    import torch.nn.functional as F
    m = w_gate_up.shape[-1] // 2
    a2 = a.reshape(-1, a.shape[-1]).float()
    with torch.enable_grad():
        gu = (a2 @ w_gate_up.float()).requires_grad_()
        y = F.silu(gu[:, :m]) * gu[:, m:]
        (dgu,) = torch.autograd.grad(y, gu, do.reshape(-1, m).float())
    dgu = dgu.abs()
    return ((dgu @ w_gate_up.float().abs().T).reshape(a.shape),
            a2.abs().T @ dgu)


def swiglu_bwd_pairs(a, w_gate_up, do):
    """The SwiGLU backward kernels (`swiglu_bwd_da`, `swiglu_bwd_dw`) and
    their plain version on the same inputs. Returns ([(label, kernel,
    plain, terms)] for da and dw; the kernel's dgu)."""
    from .kernels import swiglu as ksw
    da, dgu = ksw.swiglu_bwd_da(a, w_gate_up, do)
    dw = ksw.swiglu_bwd_dw(a, dgu)
    da_p, dw_p = ksw._ref_bwd(a.float(), w_gate_up.float(), do.float())
    da_t, dw_t = swiglu_bwd_terms(a, w_gate_up, do)
    return [("da", da, da_p, da_t), ("dw", dw, dw_p, dw_t)], dgu
