#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; imports nothing of JAX or of the JAX package.
Phases, each of which fails the run on a miss:

1. device — the card's name, count and power limit;
2. build — the port's CUDA kernels from `paddle_tpu_torch/csrc`;
3. kernels — each kernel of the serving path held against its plain
   PyTorch version on the card, at the slice's shapes, in bf16 and in
   f32 (TF32 off), element by element within the stated limit (`TOL`);
   bf16 timed with CUDA
   events beside its plain version, the library call where one exists,
   and its bound (bytes over 3.35 TB/s vs operations over the dtype's
   peak);
4. slice — full-width llama_7b (32 layers, random weights from a seeded
   generator) behind the port's HTTP gateway, 4 concurrent streamed
   requests; every kernel's launch counter must account for every step;
   three captured mixed prefill/decode steps re-run through the kernel
   route and the plain route must agree within `STEP_ATOL` and
   `STEP_MEAN_ATOL`; the first is then timed on both routes and traced
   by torch.profiler, its device time split by kernel group.

The line before the last holds the card's name and power limit as
nvidia-smi reports them; before it, one JSON line with every kernel's
measurements; the last line is the contract line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import http.client
import json
import subprocess
import sys
import threading
import time
import warnings

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12}    # f32 outside the tensor cores
# Kernel against plain version, element by element:
#     |kernel - plain| <= atol + rtol * |plain|,   TOL[(kernel, dtype)]
# = (atol, rtol). bf16: the plain version runs on f32 copies of the same
# bf16 inputs and keeps its f32 result (attention keeps the one bf16
# step of its float order: q pre-scaled in q's dtype); the kernel
# rounds its f32 result to bf16 once (unit roundoff 2^-8), so rtol is
# two roundoffs and atol covers the f32 summation order near zero.
# f32: summation order only, an absolute limit at the phase's inputs.
BF16_RTOL = 2.0 ** -7
TOL = {("rms_norm", "bfloat16"): (1e-5, BF16_RTOL),
       ("rms_norm", "float32"): (5e-5, 0.0),
       ("swiglu", "bfloat16"): (1e-4, BF16_RTOL),
       ("swiglu", "float32"): (2e-3, 0.0),
       ("ragged_paged_attention", "bfloat16"): (1e-5, BF16_RTOL),
       ("ragged_paged_attention", "float32"): (8e-5, 0.0)}
# A captured 32-layer serving step, kernel route against the plain route
# (`plain_routes`, SwiGLU in f32), |logit difference| over the live rows:
# the routes differ by bf16 rounding flips that compound through 32
# residual layers of random weights. Three captured steps on an H100
# read 0.200684-0.238281 max and 0.0342555-0.0380683 mean; the limits
# give each about twice that.
STEP_ATOL = 0.5
STEP_MEAN_ATOL = 0.08
SOURCES = {
    "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/kernels/rms_norm.py:48"),
    "swiglu": ("paddle_tpu_torch/csrc/swiglu.cu",
               "paddle_tpu/kernels/swiglu.py:189"),
    "ragged_paged_attention": (
        "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "paddle_tpu/kernels/ragged_paged_attention.py:266"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def device_phase():
    import torch
    check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"device: {name}  count={count}  ({smi_line})", flush=True)
    return name, count, smi_line


def time_ms(fn, iters, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ragged_case(torch, dtype, gen):
    """The slice's attention shapes: T=128 packed rows, 32 heads of 128,
    pages of 16, 64 pages per sequence, 4 slots mixing a prefill chunk
    deep in a 700-token prompt, a decode row at 300, an idle slot and a
    fresh 64-token prefill, plus 3 padding rows."""
    T, nh, d, page, B, ppmax = 128, 32, 128, 16, 4, 64
    n_pages = B * ppmax + 1
    rows = [(0, 60, 700), (60, 1, 300), (0, 0, 0), (61, 64, 64)]
    q = torch.randn((T, nh, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((nh, n_pages, page, d), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((nh, n_pages, page, d), generator=gen,
                     device="cuda").to(dtype)
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).to(torch.int32)
    pt = torch.zeros((B, ppmax), dtype=torch.int32, device="cuda")
    nxt = 0
    for s, (_, _, kl) in enumerate(rows):
        n = -(-kl // page)
        pt[s, :n] = perm[nxt:nxt + n]
        nxt += n
    meta = [torch.tensor([r[i] for r in rows], dtype=torch.int32,
                         device="cuda") for i in range(3)]
    return (q, kp, vp, *meta, pt), rows


def kernel_phase(report):
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = 1e-5
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        gen = torch.Generator(device="cuda").manual_seed(1234)
        it = torch.finfo(dtype).bits // 8

        def held(name, fn_kernel, fn_plain, fn_f32, nbytes, flops,
                 library=None, iters=50):
            """fn_plain: the plain version as the port runs it (timed);
            fn_f32: the same on f32 copies of the inputs, held against
            the bf16 kernel (f32: fn_plain itself)."""
            out = fn_kernel()
            torch.cuda.synchronize()
            ref = (fn_plain if dtype == torch.float32 else fn_f32)()
            torch.cuda.synchronize()
            diff = (out.double() - ref.double()).abs()
            atol, rtol = TOL[(name, dname)]
            limit = atol + rtol * ref.double().abs()
            err = diff.max().item()
            worst = (diff / limit).max().item()
            ok = worst <= 1.0 and bool(torch.isfinite(out).all())
            print(f"kernel {name} {dname}: max_abs_err={err:.6g} "
                  f"worst err/limit={worst:.6g} (limit {atol:g} + "
                  f"{rtol:g}*|plain|, max|plain| "
                  f"{ref.abs().max().item():.6g}) {'ok' if ok else 'MISS'}",
                  flush=True)
            check(ok, f"{name} {dname} disagrees with its plain version")
            if dtype != torch.bfloat16:
                return
            ms = time_ms(fn_kernel, iters)
            plain_ms = time_ms(fn_plain, max(iters // 5, 3))
            with warnings.catch_warnings():
                # F.rms_norm with a f32 weight on bf16 rows warns that it
                # takes its unfused path — that path is what is timed
                warnings.simplefilter("ignore", UserWarning)
                lib_ms = time_ms(library, iters) if library else None
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            print(f"kernel {name} bf16: kernel_ms={ms:.6g} "
                  f"plain_ms={plain_ms:.6g} library_ms="
                  f"{'none' if lib_ms is None else f'{lib_ms:.6g}'} "
                  f"bound_ms={b_ms:.6g} ({b_by})", flush=True)
            src, replaces = SOURCES[name]
            report[name] = {"name": name, "route": "cuda", "source": src,
                            "replaces": replaces, "launches": None,
                            "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": lib_ms}

        # rms_norm at the slice's [128, 4096]
        x = torch.randn((128, 4096), generator=gen, device="cuda").to(dtype)
        w = 1 + 0.1 * torch.randn((4096,), generator=gen, device="cuda")
        held("rms_norm",
             lambda: krn.rms_norm(x, w, eps, use_kernel=True),
             lambda: krn._plain(x, w, eps),
             lambda: krn._plain(x.float(), w, eps),
             nbytes=2 * x.numel() * it + w.numel() * 4,
             flops=4 * x.numel(),
             library=lambda: F.rms_norm(x, (4096,), w, eps))

        # swiglu: a [128, 4096] @ w_gate_up [4096, 22016]
        a = torch.randn((128, 4096), generator=gen, device="cuda").to(dtype)
        wgu = (0.02 * torch.randn((4096, 22016), generator=gen,
                                  device="cuda")).to(dtype)
        held("swiglu",
             lambda: ksw.swiglu(a, wgu, use_kernel=True),
             lambda: ksw._ref(a, wgu),
             lambda: ksw._ref(a.float(), wgu.float()),
             nbytes=(a.numel() + wgu.numel() + 128 * 11008) * it,
             flops=2 * 128 * 4096 * 22016)
        del wgu

        # ragged paged attention at the slice's shapes
        args, rows = ragged_case(torch, dtype, gen)
        q = args[0]
        nh, d = q.shape[1], q.shape[2]
        kv_tokens = sum(kl for _, _, kl in rows)
        nbytes = (2 * q.numel() * it + 2 * kv_tokens * nh * d * it
                  + sum(m.numel() * 4 for m in args[3:]))
        flops = sum(4 * (kl - ql + t + 1) * d * nh
                    for _, ql, kl in rows for t in range(ql))
        scale = 1.0 / d ** 0.5
        held("ragged_paged_attention",
             lambda: krpa.ragged_paged_attention(*args, use_kernel=True),
             lambda: krpa._dense_fallback(*args, scale),
             lambda: krpa._dense_fallback(
                 (q * scale).float(), args[1].float(), args[2].float(),
                 *args[3:], 1.0),
             nbytes=nbytes, flops=flops, iters=50)
        del args, q
        torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_routes():
    """Swap the kernel wrappers the model calls for their plain
    versions (the comparison route; the port itself never does this).
    SwiGLU runs on f32 copies and rounds once, as the kernel does; the
    other two plain versions already keep f32 inside."""
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw
    saved = (krn.rms_norm, ksw.swiglu, krpa.ragged_paged_attention)
    krn.rms_norm = lambda x, w, eps=1e-6, use_kernel=None: krn._plain(
        x, w, eps)
    ksw.swiglu = lambda a, w, use_kernel=None: ksw._ref(
        a.float(), w.float()).to(a.dtype)
    krpa.ragged_paged_attention = (
        lambda q, kp, vp, qs, ql, kl, pt, scale=None, use_kernel=None:
        krpa._dense_fallback(q, kp, vp, qs, ql, kl, pt, scale))
    try:
        yield
    finally:
        krn.rms_norm, ksw.swiglu, krpa.ragged_paged_attention = saved


def post_stream(port, prompt, max_new, out, idx, deadline_s=300.0):
    """POST one streamed /v1/generate; record TTFT, tokens, end status.
    Gives up (end None) after deadline_s: keepalive frames would keep a
    stalled stream open forever."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/generate",
                 body=json.dumps({"prompt": prompt,
                                  "max_new_tokens": max_new}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    toks, ttft, end, event = [], None, None, None
    for raw in resp:
        if time.perf_counter() - t0 > deadline_s:
            break
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[7:]
        elif line.startswith("data: "):
            payload = json.loads(line[6:])
            if event is None:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.extend(payload["tokens"])
            else:
                end = (event, payload)
    conn.close()
    out[idx] = {"tokens": toks, "ttft_s": ttft, "end": end,
                "wall_s": time.perf_counter() - t0}


def slice_phase(report, smi_line):
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.models import llama as L

    cfg = L.llama_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = L.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    torch.cuda.synchronize()
    print(f"slice: llama_7b bf16 built in {time.perf_counter() - t0:.3f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters",
          flush=True)
    engine = gw.build_engine(model, max_batch=4, max_seq=1024, page_size=16,
                             max_chunk_tokens=64, device="cuda")
    check(engine._T_pack == 128, f"packed rows {engine._T_pack} != 128")

    # capture three mixed prefill + decode steps' inputs (pools before)
    captured = []
    real_fn = engine._ragged_fn

    def capturing_fn():
        step = real_fn()

        def run(state, toks, k_pool, v_pool, page_ids, offs, pos,
                page_table, q_start, q_len, kv_len, produce, prev, g):
            if (len(captured) < 3 and bool((q_len > 1).any())
                    and bool((q_len == 1).any())
                    and int((q_len > 0).sum()) >= 3):
                captured.append(([t.clone() for t in (
                    toks, pos, page_ids, offs, page_table, q_start, q_len,
                    kv_len)], (k_pool.clone(), v_pool.clone())))
            return step(state, toks, k_pool, v_pool, page_ids, offs, pos,
                        page_table, q_start, q_len, kv_len, produce, prev, g)

        return run

    engine._ragged_fn = capturing_fn
    gateway = gw.ServingGateway(gw.EngineRunner(engine), port=0)
    port = gateway.start()
    try:
        warm = {}
        post_stream(port, [1, 2, 3, 4, 5], 2, warm, 0)
        check(warm[0]["end"] and warm[0]["end"][1]["status"] == "served",
              f"warm-up request did not serve: {warm[0]['end']} "
              f"(engine fault: {gateway.runner.fatal!r})")
        rng = np.random.RandomState(0)
        prefix = rng.randint(1, cfg.vocab_size, 48).tolist()
        prompts = [rng.randint(1, cfg.vocab_size, 17).tolist(),
                   rng.randint(1, cfg.vocab_size, 100).tolist(),
                   prefix + rng.randint(1, cfg.vocab_size, 252).tolist(),
                   prefix + rng.randint(1, cfg.vocab_size, 652).tolist()]
        max_new = 32
        krn.rms_norm.launches = 0
        ksw.swiglu.launches = 0
        krpa.ragged_paged_attention.launches = 0
        steps0, ticks0 = engine.model_steps, engine.ticks
        results = {}
        t_burst = time.perf_counter()
        threads = [threading.Thread(target=post_stream,
                                    args=(port, p, max_new, results, i))
                   for i, p in enumerate(prompts)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), "a request thread did not finish")
        wall = time.perf_counter() - t_burst
        launches = {"rms_norm": krn.rms_norm.launches,
                    "swiglu": ksw.swiglu.launches,
                    "ragged_paged_attention":
                        krpa.ragged_paged_attention.launches}
        steps = engine.model_steps - steps0
        ticks = engine.ticks - ticks0
        health = engine.health_snapshot()
    finally:
        gateway.drain(timeout=60)
        gateway.stop()

    for i, p in enumerate(prompts):
        r = results.get(i)
        check(r is not None, f"request {i} returned nothing")
        check(r["end"] is not None and r["end"][0] == "end"
              and r["end"][1]["status"] == "served",
              f"request {i} (prompt {len(p)}) ended {r['end']}")
        check(len(r["tokens"]) == max_new,
              f"request {i} got {len(r['tokens'])} tokens, not {max_new}")
        check(all(0 <= t < cfg.vocab_size for t in r["tokens"]),
              f"request {i} produced an out-of-vocab token")
    L_ = cfg.num_hidden_layers
    want = {"rms_norm": steps * (2 * L_ + 1), "swiglu": steps * L_,
            "ragged_paged_attention": steps * L_}
    for name, n in launches.items():
        print(f"launches {name}: {n} (steps {steps} -> expected "
              f"{want[name]})", flush=True)
        check(n == want[name] and n > 0,
              f"{name} launched {n} times, expected {want[name]}")
        report[name]["launches"] = n
    check(engine.pool.n_free == engine.pool.n_pages - 1,
          "KV pool not fully free after draining")
    ttfts = [results[i]["ttft_s"] for i in range(len(prompts))]
    n_tok = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
    print(f"serve: ticks={ticks} steps={steps} prompts="
          f"{[len(p) for p in prompts]} max_new={max_new} "
          f"prefix_cache={health.get('prefix_cache', {}).get('hits')} hits "
          f"preemptions={health['counters']['preemptions']} "
          f"[{smi_line}]", flush=True)
    print(f"serve: ttft_ms={[round(1e3 * t, 3) for t in ttfts]} "
          f"wall_s={wall:.6g} tokens_per_s={n_tok / wall:.6g} "
          f"[{smi_line}]", flush=True)

    # the captured steps through the kernel route and the plain route
    check(len(captured) == 3, f"{len(captured)} of 3 mixed prefill/decode "
          f"steps with 3+ live sequences were captured")
    for i, (args, (kp0, vp0)) in enumerate(captured):
        with torch.no_grad():
            lg_k, _, _ = L._ragged_step_paged(
                engine.state, cfg, args[0], args[1], kp0.clone(),
                vp0.clone(), *args[2:], wls=engine._wls)
            torch.cuda.synchronize()
            with plain_routes():
                lg_p, _, _ = L._ragged_step_paged(
                    engine.state, cfg, args[0], args[1], kp0.clone(),
                    vp0.clone(), *args[2:], wls=engine._wls)
            torch.cuda.synchronize()
        live = args[6] > 0
        diff = (lg_k[live] - lg_p[live]).abs()
        err = diff.max().item()
        agree = int((lg_k[live].argmax(-1) == lg_p[live].argmax(-1)).sum())
        mean = diff.mean().item()
        ok = (err <= STEP_ATOL and mean <= STEP_MEAN_ATOL
              and bool(torch.isfinite(lg_k).all()))
        print(f"step {i}: q_len={args[6].tolist()} kernel vs plain route "
              f"logits max_abs_err={err:.6g} (limit {STEP_ATOL:g}) "
              f"mean_abs_err={mean:.6g} (limit {STEP_MEAN_ATOL:g}) "
              f"max|logit|={lg_p[live].abs().max().item():.6g} "
              f"argmax agree {agree}/{int(live.sum())} "
              f"{'ok' if ok else 'MISS'}", flush=True)
        check(ok, f"kernel-route step {i} disagrees with the plain route")
    args, (kp0, vp0) = captured[0]
    step_breakdown(L, engine, cfg, args, kp0, vp0, wall / steps, smi_line)


# device-kernel name fragments -> the group a step's time is charged to
_KERNEL_GROUPS = (("rms_norm_kernel", "rms_norm"), ("swiglu_", "swiglu"),
                  ("ragged_paged_attention_kernel", "ragged_paged_attention"),
                  ("gemm", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"),
                  ("cutlass", "gemm"))


def step_breakdown(L, engine, cfg, args, kp, vp, wall_per_step_s, smi_line):
    """Where one serving step's time goes: the captured step through the
    kernel route and the plain route timed with CUDA events, then three
    kernel-route steps traced by torch.profiler, device time summed by
    kernel group; busy share = device time per step over the step's
    event time. Re-running the step rewrites the same pool slots."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        L._ragged_step_paged(engine.state, cfg, args[0], args[1], kp, vp,
                             *args[2:], wls=engine._wls)

    with torch.no_grad():
        step_ms = time_ms(step, 10)
        with plain_routes():
            plain_ms = time_ms(step, 3)
        n = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    print(f"step: captured step kernel_route_ms={step_ms:.6g} "
          f"plain_route_ms={plain_ms:.6g} burst_wall_per_step_ms="
          f"{1e3 * wall_per_step_s:.6g} [{smi_line}]", flush=True)
    groups = {g: 0.0 for _, g in _KERNEL_GROUPS}
    groups["other"] = 0.0
    others = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3 / n
        group = next((g for frag, g in _KERNEL_GROUPS if frag in e.key),
                     None)
        if group is None:
            group = "other"
            others[e.key] = ms
        groups[group] += ms
    busy = sum(groups.values())
    if busy == 0.0:
        print("step profile: not measured (the profiler saw no device "
              "time)", flush=True)
        return
    parts = " ".join(f"{g}={ms:.6g}" for g, ms in groups.items())
    print(f"step profile (device ms per step): {parts} total={busy:.6g} "
          f"busy_share={busy / step_ms:.4f} [{smi_line}]", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print("step profile, largest other kernels (ms per step): "
          + "; ".join(f"{k[:60]}={ms:.4g}" for k, ms in top), flush=True)


def main():
    try:
        name, count, smi_line = device_phase()
        t0 = time.perf_counter()
        from paddle_tpu_torch.kernels import _build
        _build.library()
        print(f"build: kernels built and loaded in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        report = {}
        kernel_phase(report)
        slice_phase(report, smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": [report[k] for k in SOURCES]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
