#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; imports nothing of JAX or of the JAX package.
Phases, each of which fails the run on a miss:

1. device — the card's name, count and power limit;
2. build — the port's CUDA kernels from `paddle_tpu_torch/csrc`;
3. kernels — each kernel of the serving and the training path held
   against its plain PyTorch version on the card, at the slices' shapes
   (rms_norm and swiglu at every row count of the serving, decode,
   prefill and training paths; fused_add_rms_norm, the SwiGLU backward
   and flash attention at llama_1b's and llama_7b's training shapes,
   `TRAIN_KERNEL_SHAPES`; paged decode attention at
   `testing.PAGED_DECODE_CASES`, generate's own cache among them; the
   fused cross-entropy forward and backward at `testing.
   FUSED_CE_CASES`, the 7B training slice's [8188, 32000] among them),
   in bf16 and in f32 (TF32 off), element by element within the stated
   limit (`TOL`, and testing.py's `CE_LIMITS`); bf16 timed with CUDA
   events beside its plain version, the library call where one exists,
   and its bound (bytes over 3.35 TB/s vs operations over 989 TFLOP/s
   in bf16 tensor-core work, 494.7 in tf32 (the f32 flash kernels'
   3xTF32 products, three a product), 67 in f32 elementwise work);
4. serving — full-width llama_7b (32 layers, random weights from a
   seeded generator) behind the port's HTTP gateway, 4 concurrent
   streamed requests queued in a fixed order before the first tick,
   through the default engine: self-speculative decoding armed (4
   drafts); every kernel's launch counter must account for every step;
   drafted, accepted, acceptance rate, ticks, TTFT and tokens/s; three
   captured mixed prefill/decode steps and at least one step with a
   speculative verify entry (q_len > 1) re-run through the kernel route
   and the plain route must agree within `STEP_ATOL` and
   `STEP_MEAN_ATOL` at the [B, K, V] logits of their live rows; the
   verify lm-head (`_verify_logits`, K products of [4, 1, 4096]) must
   equal under torch.equal the last-row products of the same rows, and
   a product's rows must not depend on the batch's other rows; the first
   captured step is then timed on both routes and traced by
   torch.profiler, its device time split by kernel group;
4b. the same burst through the engine with `speculative=False` (the
   kill switch): each stream's tokens equal to phase 4's; ticks and
   tokens/s beside phase 4's;
4c. the same burst through the speculative engine with an oracle
   drafter (`_draft_for_slot` replaced): it proposes 4b's own tokens,
   the one for every output position p with p % 3 == 2 corrupted; the
   tokens must equal 4b's, the accepted count must equal what the
   corruption pattern predicts for the drafts proposed, at least one
   tick must commit several tokens and one roll drafts back, and the
   pool must be free after the run;
5. generate — the same llama_7b through `LlamaForCausalLM.generate`,
   4 prompts of 128 tokens (`default_rng(0)`), 64 new tokens, greedy:
   prefill ms, per-token decode ms and decode tokens/s by CUDA events;
   launch counters exact (paged decode attention L per decode step,
   rms_norm 2L+1 and swiglu L per forward); one captured decode step's
   logits through the kernel route and the plain route within
   `GEN_STEP_ATOL` / `GEN_STEP_MEAN_ATOL`;
6. bucketed serving — the same burst as phase 4 through the gateway
   over the engine's bucketed regime (`ragged=False`): every stream
   served whole, paged decode attention launched L times per decode
   tick, rms_norm and swiglu per prefill call and decode tick; TTFTs,
   tokens/s, ticks;
6b. SLO layer — the same llama_7b through the default engine, the SLO
   layer armed (with speculation): (a) phase 4's burst armed and under
   FLAGS_serving_slo=0, each stream's tokens and the per-tick trace
   (packed rows, finished, preemptions) identical, 0 quarantines, step
   ms, tokens/s and the host ms a tick in `_slo_pre_tick` +
   `_slo_post_tick`; (b) through the gateway: a priority-1 request
   queued behind three others finishes first, a deadline_s of 1e-9
   answers 504, a full queue answers 429 with an integer Retry-After in
   [1, 60], a pool held above 0.85 utilisation shows `degraded` and a
   halved `effective_chunk_tokens` at /healthz and still serves every
   request with the pool whole; (c) NaN written into a victim request's
   KV pages after its prefill: the next step, through row 9's kernel,
   quarantines exactly that request with "non-finite logits", the
   other streams are token-identical to a clean run, and a request
   then served on the victim's reclaimed pages is token-identical to
   the same request on a fresh engine; the same through the bucketed
   engine and row 13's kernel; (d) FLAGS_fault_inject=serving.tick:
   raise@3 fails one request alone, the others token-identical;
6c. request tracing and the serving telemetry — the same llama_7b
   through the default engine, tracing armed by default: (a) phase 4's
   burst with observability armed (request traces, CUDA event pairs
   around each step) and under FLAGS_request_trace=0 with it off (armed,
   off, off, armed): each stream's tokens and the per-tick trace
   identical, step ms, tokens/s and the host ms a tick inside the trace
   and device-event calls (`HookClock`), then the same prompts driven
   tick by tick under torch.profiler on each side: the same count of
   synchronizing CUDA runtime calls (`testing.sync_calls`); (b) through
   the gateway, one stream with a `traceparent`: an X-Request-Id on
   every stream (the traceparent's id kept), each GET /v1/trace/<id>
   `served` with arrival, admitted, prefill_chunk, first_token and
   finished and buckets summing to the wall within 1e-6 s, 404 for an
   unknown id, /metrics with `serving_attribution_seconds` exemplars,
   one `xla.execute_seconds{executable="serving.ragged_step"}` reading
   a tick, each > 0 and within its tick's host wall; (c)
   FLAGS_flight_recorder with `tick_timeout_s` 0.5 and one tick delayed
   1.5 s (`serving.tick:delay:1.5@4`): a dump naming
   `watchdog:serving.tick` with the section's span open, every request
   served; (d) FLAGS_request_trace_sink during (b): each request's
   terminal JSONL record equal to its /v1/trace snapshot;
6d. weight-only int8 — the same llama_7b: (a) `serve`'s engine with
   quantize="int8" (every projection and the lm head int8 with
   per-column scales, each product on the W8A16 kernel) runs phase 4's
   burst through the gateway, speculation armed: TTFT, tokens/s, one
   captured step's ms on both routes, its device ms by kernel group and
   busy share; launches exact (W8A16 4L + K a step, rms_norm 2L+1 and
   ragged attention L, the SwiGLU kernel 0); that step's peak
   allocation above the state and pools below one quantized
   projection's bf16 size (o_proj: no dequantized weight is made);
   (b) the bucketed int8 engine on the same burst (W8A16 4L + 1 a
   forward, paged decode L a decode tick); (c) the verify case of
   `RAGGED_ROWS` through the int8 layers: 20/20 verify rows bitwise
   their decode rows (`testing.verify_bitwise`); (d) the model's
   weights replaced by the dequantized int8 weights, the default bf16
   engine on the same burst: each stream's tokens equal to (a)'s, or
   its first difference at a top-2 logit gap of the bf16 model within
   `testing.INT8_GAP_LIMIT`; (e) the incubate functions at llama_7b
   width (H 4096, 32 heads of 128, batch 4): `fused_rms_norm`,
   `block_multihead_attention`, `masked_multihead_attention`,
   `variable_length_memory_efficient_attention`,
   `fused_multi_head_attention`, `weight_only_linear` and a 2-layer
   int8 `fused_multi_transformer` (prefill and one decode step), each
   against its plain route within `testing.SURFACE_RTOL`, launches of
   rows 1, 10, 13 and 14 exact, ms a call;
7. training — full-depth llama_1b (22 layers, bf16, random weights from
   a seeded generator) through `TrainStep` with AdamW, batch 4 x seq
   2048 on one repeated batch, as bench.py runs it: 2 warm-up steps,
   then `TRAIN_STEPS` timed steps whose losses must be finite and fall;
   step ms, tokens/s and MFU (bench.py's PaLM count over 989 TFLOP/s);
   every training kernel's launch counter must equal its count per step
   times the steps; a 2-layer model at full width runs one forward and
   backward on the kernel route and the plain route, whose loss and
   grads must agree within `TRAIN_LOSS_RTOL` and `TRAIN_GRAD_RTOL`; one
   more step is traced by torch.profiler, its device time split by
   kernel group;
8. 7B training — full-depth llama_7b (32 layers, bf16, random weights
   from a seeded generator) as bench.py's 7B configuration runs it:
   `use_recompute=True` under `TrainStep`'s default remat policy
   "save_matmul_outputs", FLAGS_use_fused_ce=1, AdamW, batch 4 x 2048;
   `TRAIN7B_WARMUP` warm-up and `TRAIN7B_STEPS` timed steps whose losses
   must be finite and fall; step ms, tokens/s, MFU (recompute FLOPs not
   counted, as bench.py counts), peak memory; every training kernel's
   launch counter exact for the policy that ran; one traced step split
   by kernel group. Then a 2-layer model at full 7B width: one forward
   and backward without remat and under each remat policy, loss and
   every grad bitwise equal and peak memory ordered nothing <=
   save_matmul_outputs < no remat; and the kernel route (remat, fused
   cross-entropy) against the plain route within `TRAIN7B_LOSS_RTOL`
   and `TRAIN7B_GRAD_RTOL`.

9. BERT — bench.py's BERT configuration at inference: `BertForMaskedLM`
   at bert_base (hidden 768, 12 layers, 12 heads of 64, vocab 30522),
   f32, eval, batch 16 x 512 of `default_rng(0)` ids padded to
   `testing.bert_lengths()` (one row of 512); forward ms by CUDA events
   (BERT_WARMUP, then BERT_ITERS), sequences/s and valid tokens/s; the
   segment flash forward launched 12 times a forward and no other
   attention kernel; the kernel route against the plain route at valid
   rows within testing's BERT limits; one forward traced by
   torch.profiler, its device time split by kernel group;
9b. encoder training — bench.py's two encoder configurations
   (bench.py:399-421, 462) at full width and depth, f32, batch 16 x 512
   of `default_rng(0)` ids, `model.loss(ids, ids)`, AdamW(1e-4, weight
   decay 0.01) through `TrainStep`, dropout armed (train mode, 0.1),
   ENC_WARMUP warm-up and ENC_STEPS timed steps: (a) ErnieForPretraining
   at ernie_base: step ms by CUDA events, wall per step, tokens/s, MFU by
   bench.py's count over 989 TFLOP/s and its share of the f32 rate (67),
   peak memory; row 10's one-length f32 flash forward, delta and backward
   launched exactly 12 times a step each (`testing.encoder_launches`),
   every other attention kernel 0; one traced step split by group
   (cuBLAS, flash, AdamW, plain torch, busy share), its flash launches
   held to their 3xTF32 cores (`expected_flash_routes`); two more steps'
   dropout masks each binomial and all new in the second step; (b) a
   2-layer full-width ernie_base at dropout 0, one train-mode forward and
   backward on the kernel route against `plain_routes()` within
   testing's ENCODER_LOSS_RTOL / ENCODER_GRAD_RTOL; (c)
   BertForMaskedLM at bert_base (hidden and probs dropout 0.1: the
   reference's dense route), the readings of (a) with 0 attention kernel
   launches; (d) a 2-layer full-width bert_base, dropout 0, on the
   padded batch of `testing.bert_lengths()` with -100 labels on padding:
   the f32 segment forward, delta, dkv and dq once a layer each and no
   other attention kernel, held to their 3xTF32 cores, against the plain
   route within BERT_TRAIN_LOSS_RTOL / BERT_TRAIN_GRAD_RTOL; (e) dropout
   on the card: a 16 x 512 x 768 keep mask within DROPOUT_SIGMAS of the
   binomial, equal masks from equal generator seeds, the stream after
   `core.seed(s)` equal to a generator seeded s, p = 1 zeroes, p = 0
   and eval the identity; the phase's wall is printed;
9c. the optimizer surface — (a) runs inside phase 8, on its llama_7b
   after its plain steps, once their optimizer's state is freed: the
   LLaMA 2 recipe (Touvron et al. 2023, §2.2: AdamW β1 0.9, β2 0.95, eps
   1e-5, weight decay 0.1, `ClipGradByGlobalNorm(1.0)`, 2000 warmup
   steps to 3e-4 then cosine to 3e-5, `llama2_schedule`, stepped after
   each `TrainStep`), RECIPE_WARMUP warm-up and RECIPE_STEPS timed
   steps: step ms beside the plain step's, peak memory, the lr of each
   step equal to a fresh schedule's, finite losses, exact launches, the
   synchronizing CUDA runtime calls of one step beside the plain step's
   (`step_syncs`), and one more step traced in three windows (forward
   and backward, the clip alone, the update) for the clip's device ms;
   (b) llama_1b built f32 and decorated by `amp.decorate(level="O2")` to
   bf16 (f32 masters), AdamW(3e-4 warmup as (a), weight decay 0.1) and
   the same clip, batch 4 x 2048: rows 1 and 5 with the bf16 weight
   held to their plain versions and timed beside an f32 weight; steps
   without a scaler, then through `TrainStep(scaler=GradScaler(2**15))`
   (exact launches): step ms beside phase 7's bf16 step, peak memory of
   each, synchronizing calls a step equal on both; then one step whose
   grads a hook makes non-finite leaves every parameter, master and
   moment torch.equal, halves the scale and advances @step, and the next
   step moves every master; (c) a 2-layer llama_1b-width f32 model on
   the card and its copy on the CPU: each of `testing.opt_card_cases`
   (every optimizer but LBFGS, Adam amsgrad, RMSProp centered, Momentum
   Nesterov, each clip) takes ZOO_STEPS steps on both from the card's
   grads, parameters and accumulators within testing.OPT_CARD_RTOL of
   the CPU's and no synchronizing call in a step; LBFGS takes ZOO_STEPS
   steps through a closure on each device (OPT_LBFGS_RTOL); then
   llama_1b bf16 at 4 x 2048, one AdamW step with `accumulate_steps=2`
   against one full-batch step from the same weights: loss and weights
   within testing.ACCUM_LOSS_RTOL / ACCUM_WEIGHT_RL2, the step's peak
   memory lower, launches twice a pass's;
10. attention surface — bf16: sdpa with the boolean [16, 1, 1, 512]
   padding mask, sdpa with the additive float mask (the bias route) and
   flash_attn_unpadded on the same batch packed, each against its plain
   route and against each other at valid rows, output and grads
   (testing.SURFACE_RTOL), exact launches; then at llama_7b attention
   width a packed causal flash_attn_unpadded over 8192 tokens of
   documents and a causal alibi flash_attention_biased at 4 x 2048 and
   at 2 x 4096 (there one f32 score buffer exceeds the bound), whose
   peak memory above its inputs must stay under `alibi_peak_bound`;
   forward and backward timed, the biased route's beside SDPA with its
   bias as attn_mask. The biased routes (float mask, alibi) launch one
   bias forward, one dkv and one dq each, and no block-stats kernel.
11. nn.Transformer — Transformer base for WMT14 En-De (Vaswani et al.
   2017, Table 3: 6 + 6 layers, d_model 512, d_ff 2048, 8 heads, P_drop
   0.1, label smoothing 0.1, a shared 37000-token vocabulary whose
   embedding is also the output projection, sinusoidal positions) built
   from the port's `nn` pieces (`_seq2seq`), f32 with TF32 off, random
   weights from a seeded generator: (a) 64 sentence pairs of
   default_rng(0) lengths in [16, 128] padded to 128 (an additive 0 /
   -1e9 [B, 1, 1, S] source mask, `generate_square_subsequent_mask` on
   the target) through `TrainStep` with label-smoothed cross-entropy,
   Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000), TR_WARMUP warm-up
   and TR_STEPS timed steps: step ms, target tokens/s, peak memory,
   finite losses, 0 launches of every attention kernel (dropout 0.1
   takes the reference's dense route) and of the fused cross-entropy
   (label smoothing leaves its fast path), one traced step by group
   (cuBLAS, Adam, plain torch) and busy share; (b) a 2-layer model at
   dropout 0, targets as long as the sources, one forward and backward
   against `plain_routes()` with the float masks (row 12's bias
   forward, dkv and dq) and with a bool source mask (row 10's segment
   forward, delta, dkv and dq), launches exact, loss and grads within
   testing's TRANSFORMER limits, and the bool run's against the float
   run's within the same limits (a valid target row at a padded source
   index keeps its keys); (c) beam
   search: 16 sources of default_rng(1) lengths, `BeamSearchDecoder`
   (beam 4) over a cell stepping the decoder on its Cache and
   StaticCache, `dynamic_decode(max_step_num=64)`: 6 bias forwards a
   encoder forward, and a decode step 6 bias forwards and 6 row-10
   forwards (the one-length kernel at the first step, the segment
   kernel without ids after it), exactly; encoder ms, ms a step,
   generated tokens/s, the host's share of a step (the decode steps
   traced alone, every attention forward in the trace); token paths and
   lengths equal to the plain route's, or parting only within
   testing.BEAM_GAP_LIMIT; (d) row 12's f32 bias forward at the decode
   shape (q [64, 1, 8, 64] against 128 keys) and the encoder's, and row
   10's forward at Sq = 1, Sk = 64 without ids, each against its plain
   version and timed by events and device time beside SDPA with the
   same mask and the bound: these run right after the kernel phase
   (late in a long run the profiler has dropped whole traces).
12. the conv slice — cuDNN's TF32 switch set to its default (on): the
   conv functionals keep f32 convolutions in f32 themselves. (a)
   bench.py's ResNet-50 (l.422-431): `resnet50(num_classes=1000)`, f32,
   64 x 3 x 224 x 224 default_rng(0) normals and labels, cross-entropy,
   AdamW(1e-4, weight decay 0.01) through `TrainStep`, P12_WARMUP
   warm-up and P12_STEPS timed steps by CUDA events: step ms, images/s,
   MFU (`testing.forward_flops` x 3 over 989 TFLOP/s; f32 with TF32 off
   caps it at 0.068), peak memory, finite losses; the parameter count
   held to testing's; one more step traced (the forward and backward,
   then the update, each window held to its markers, else "not
   measured"), its device ms by group (cuDNN forward, dgrad, wgrad,
   cuBLAS, the reductions of BatchNorm, elementwise, AdamW) and busy
   share; (b) bench.py's UNet (l.432-451): block_out_channels (128, 256,
   512, 512), cross_attention_dim 512, batch 8 x 4 x 32 x 32 with
   timesteps, a [8, 16, 512] context and noise from default_rng(0), MSE,
   the readings of (a); (c) each model at B = 2 from one seed, one step
   on the card, on the CPU and in f64 on the CPU: loss and BatchNorm's
   running statistics card against CPU, grads against the f64 run
   within `testing.card_grad_limit` of the CPU's own error; (d)
   `unet_sd15()` (859.5 M parameters), one step at B = 2, latents [2, 4,
   64, 64], context [2, 77, 768], after one warm-up step: step ms, peak
   memory, finite output and losses.

Paged decode attention (row 13) is timed at the bucketed engine's case
and at generate's own cache, ragged paged attention (row 9) at the
serving step's mixed case, at the ragged burst's decode-only steady
state and at a speculative verify step (`RAGGED_ROWS`; the decode and
verify entries flagged in `row_tiles`, as the speculative engine
launches them; the verify case's 20 rows must each equal under
torch.equal the same row launched alone as a decode row, and the
reading without row tiles is printed beside it), each by events and by
the card's own time
(`device_ms`, `traced_device_ms`: each trace must hold one launch of
the kernel a call, and a reading under the bound fails), each call on
its own copy of the pools so that its pages are cold in L2
(`pool_copies`); then the split size they share is swept
(`split_sweep`, `SPLIT_SWEEP`).

rms_norm at its four timed shapes and the block-stats kernel at
`STATS_TIMED` carry, beside their event times, the card's own time
(`device_ms`, each trace held to its launches of `RMS_KERNEL` /
`STATS_KERNEL` and to the bound) and the host's time to enqueue one
wrapper call (`host_us`), by `split_times`.

The kernel phase also holds the three segment-id flash kernels, the
block-stats kernel and the three bias kernels against their plain
versions at `testing.ATTN_SEG_CASES`, `testing.STATS_CASES` and
`testing.BIAS_CASES` (the two phases' shapes among them), bf16 and f32,
and times them; every traced device time of a port kernel holds its
trace to the launches it made (`traced_device_ms(..., kernel=)`). It traces one SwiGLU forward, da and dW launch at the
7B training shape and at the card tests' scalar_edges shape and holds
each product's core (the wgmma kernel, name fragment `WGMMA_KERNEL`,
or the mma.sync `mma_kernel`) to `expected_swiglu_routes`; beside row
3's one-product library time it times the whole launch's work in
PyTorch calls (`library_whole_ms`). Flash attention is held at the
training shapes, a GQA, a head-dim-64 and a ragged-S case
(`FLASH_SMALL_CASES`), with the backward's delta pre-pass; one bf16
forward and backward at each of `FLASH_ROUTE_CASES` is traced and its
device kernels held to `expected_flash_routes` (the wgmma core, never a
flash_*_mma_kernel); the backward's library time is SDPA's backward
alone over a retained forward (`library_fwd_bwd_ms`: its forward and
backward). One segment forward, delta pre-pass, dkv and dq at each bf16
`testing.ATTN_SEG_CASES` case and at BERT's f32 shape is traced and held
to `expected_seg_routes` (bf16 on the wgmma core, forward and backward,
never an mma.sync kernel; f32 forward, dkv and dq on its 3xTF32 form,
never a SIMT kernel). The segment dkv and dq are timed beside SDPA's
backward alone over a retained forward (`library_fwd_bwd_ms`: its
forward and backward), in bf16 and, at BERT's shape, in f32; the f32
one-length flash forward and backward (3xTF32) at ERNIE's [16, 512, 12,
64] beside SDPA in f32 (`ernie_flash_f32`), traced to their cores too;
the f32 kernels, which run in 3xTF32, are bound at three tf32 products
a product at the tf32 rate (bound_ms, copied as `bound_3xtf32_ms`; the
f32 rate's bound beside it as `bound_simt_ms`), and carry the card's own
time of each side (`device_ms`, `library_device_ms`). One
bias forward, dkv and dq at each dtype is traced and held to
`expected_bias_routes` (mma.sync in bf16, SIMT in f32).

    python3 chip_smoke.py --conv

runs phase 12 alone (about 45 s on the card: it builds no kernel).

    python3 chip_smoke.py --ab PARENT_DIR

compares this checkout with another (an unpacked `git archive` of the
parent commit) on one card: `route_times` (rows 1 and 8 alone with
`--ab PARENT_DIR norm`, `norm_times`: rms_norm at the serving, decode and
training shapes and block stats at its timed cases, by events, device
time and host enqueue time; rows 9 and 13 at their
kernel-phase cases by events and device time, `paged_times`, alone with
`--ab PARENT_DIR paged` (row 9's decode-only and verify cases with row
tiles where the checkout's wrapper takes them, and without); row 10's
1B and 7B flash
forward and backward, the alibi 4 x 2048 and float-mask biased routes forward
and forward + backward, the alibi route's peak memory, the segment
forward at BERT's shape in bf16 and f32 and packed at 8192 tokens, the
segment dkv + dq at both in bf16 and at BERT's in f32, the f32
one-length forward and backward at ERNIE's shape and at llama_1b's
causal [4, 2048, 16, 128], each beside SDPA in f32, sdpa with the
boolean mask (forward, and forward + backward), flash_attn_unpadded on the BERT batch and packed
causal over 8192 tokens (forward + backward), the bert_base f32
forward, the SwiGLU
forward, da and dW launches at the 7B and 1B training shapes and the
forward at serving and decode rows) runs in a fresh process per
checkout, in the order parent, change, change, parent.

The line before the last holds the card's name and power limit as
nvidia-smi reports them; before it, one JSON line with every kernel's
measurements; the last line is the contract line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import http.client
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import warnings

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "tf32": 494.7e12,    # dense tensor-core tf32
              "float32": 67e12}    # f32 outside the tensor cores
# Kernel against plain version, element by element, by the rule of
# paddle_tpu_torch/testing.py:
#     |kernel - plain| <= atol + rtol * |plain|,   TOL[(kernel, dtype)]
# = (atol, rtol). bf16: the plain version runs on f32 copies of the same
# bf16 inputs and keeps its f32 result (attention keeps the one bf16
# step of its float order: q pre-scaled in q's dtype); the kernel
# rounds its f32 result to bf16 once (unit roundoff 2^-8), so rtol is
# two roundoffs and atol covers the f32 summation order near zero.
# f32: summation order only, an absolute limit at the phase's inputs.
# atol TERMS marks the kernels that round an intermediate to the input
# dtype before a second product (flash: P and dS; the SwiGLU backward:
# dg and du): an element's error is a roundoff of each of its terms, so
# its atol is testing.TERM_FRAC (2^-7 bf16, 1e-4 f32) of that element's
# own sum of |terms|, from the plain side. A key "kernel.output"
# overrides "kernel".
BF16_RTOL = 2.0 ** -7
TERMS = "terms"
TOL = {("rms_norm", "bfloat16"): (1e-5, BF16_RTOL),
       ("rms_norm", "float32"): (5e-5, 0.0),
       ("swiglu", "bfloat16"): (1e-4, BF16_RTOL),
       ("swiglu", "float32"): (2e-3, 0.0),
       ("ragged_paged_attention", "bfloat16"): (1e-5, BF16_RTOL),
       ("ragged_paged_attention", "float32"): (8e-5, 0.0),
       ("paged_decode_attention", "bfloat16"): (1e-5, BF16_RTOL),
       ("paged_decode_attention", "float32"): (5e-5, 0.0),
       ("fused_add_rms_norm", "bfloat16"): (1e-5, BF16_RTOL),
       ("fused_add_rms_norm", "float32"): (5e-5, 0.0),
       ("swiglu_bwd_da", "bfloat16"): (TERMS, BF16_RTOL),
       ("swiglu_bwd_da", "float32"): (TERMS, 0.0),
       ("swiglu_bwd_dw", "bfloat16"): (TERMS, BF16_RTOL),
       ("swiglu_bwd_dw", "float32"): (TERMS, 0.0),
       ("flash_attention_fwd", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_fwd", "float32"): (TERMS, 0.0),
       # the f32 log-sum-exp: the scores' summation order only
       ("flash_attention_fwd.lse", "bfloat16"): (1e-4, 1e-5),
       ("flash_attention_fwd.lse", "float32"): (1e-4, 1e-5),
       ("flash_attention_bwd", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_bwd", "float32"): (TERMS, 0.0),
       # the segment-id kernels: the flash rule over the pairs their
       # segments leave (testing.seg_flash_terms)
       ("flash_attention_seg_fwd", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_seg_fwd", "float32"): (TERMS, 0.0),
       ("flash_attention_seg_fwd.lse", "bfloat16"): (1e-4, 1e-5),
       ("flash_attention_seg_fwd.lse", "float32"): (1e-4, 1e-5),
       ("flash_attention_seg_dkv", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_seg_dkv", "float32"): (TERMS, 0.0),
       ("flash_attention_seg_dq", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_seg_dq", "float32"): (TERMS, 0.0),
       # the bias kernels: the flash rule over the entries the bias and
       # the masks leave (testing.bias_flash_terms)
       ("flash_attention_bias_fwd", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_bias_fwd", "float32"): (TERMS, 0.0),
       ("flash_attention_bias_fwd.lse", "bfloat16"): (1e-4, 1e-5),
       ("flash_attention_bias_fwd.lse", "float32"): (1e-4, 1e-5),
       ("flash_attention_bias_dkv", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_bias_dkv", "float32"): (TERMS, 0.0),
       ("flash_attention_bias_dq", "bfloat16"): (TERMS, BF16_RTOL),
       ("flash_attention_bias_dq", "float32"): (TERMS, 0.0)}
# The block-stats kernel's pairs carry their own limits
# (testing.block_stats_pairs: STATS_LIMITS for m and l, the terms rule
# for o).
# A captured 32-layer serving step, kernel route against the plain route
# (`plain_routes`, SwiGLU in f32), |logit difference| over the live rows:
# the routes differ by bf16 rounding flips that compound through 32
# residual layers of random weights. Three captured steps on an H100
# read 0.200684-0.238281 max and 0.0342555-0.0380683 mean; the limits
# give each about twice that.
STEP_ATOL = 0.5
STEP_MEAN_ATOL = 0.08
# generate's phase: llama_7b, batch 4, 128 prompt tokens, 64 new tokens;
# one decode step (32 layers) after the prompt, kernel route against the
# plain route, |logit difference| over the batch. The first reading on an
# H100 was 0.195312 max and 0.0339653 mean; the limits give each about
# twice that.
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 64
GEN_STEP_ATOL = 0.4
GEN_STEP_MEAN_ATOL = 0.07
SOURCES = {
    "rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/kernels/rms_norm.py:48"),
    "swiglu": ("paddle_tpu_torch/csrc/swiglu.cu",
               "paddle_tpu/kernels/swiglu.py:189"),
    "ragged_paged_attention": (
        "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "paddle_tpu/kernels/ragged_paged_attention.py:266"),
    # upstream Pallas TPU paged attention, reached through the wrapper
    "paged_decode_attention": ("paddle_tpu_torch/csrc/paged_attention.cu",
                               "paddle_tpu/kernels/paged_attention.py:78"),
    "fused_add_rms_norm": ("paddle_tpu_torch/csrc/fused_norm_residual.cu",
                           "paddle_tpu/kernels/fused_norm_residual.py:131"),
    "swiglu_bwd_da": ("paddle_tpu_torch/csrc/swiglu.cu",
                      "paddle_tpu/kernels/swiglu.py:219"),
    "swiglu_bwd_dw": ("paddle_tpu_torch/csrc/swiglu.cu",
                      "paddle_tpu/kernels/swiglu.py:233"),
    # upstream Pallas TPU flash attention (fwd pallas_call l.758), reached
    # through the package's wrapper; bf16 on the wgmma core
    "flash_attention_fwd": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                            "paddle_tpu/kernels/flash_attention.py:283"),
    # upstream bwd dkv l.1121 and dq l.1456, through the same wrapper
    "flash_attention_bwd": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                            "paddle_tpu/kernels/flash_attention.py:283"),
    # the backward's pre-pass D = rowsum(dO * O) (upstream's jnp l.1664,
    # inside the same backward)
    "flash_attention_delta": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                              "paddle_tpu/kernels/flash_attention.py:283"),
    "fused_cross_entropy": ("paddle_tpu_torch/csrc/cross_entropy.cu",
                            "paddle_tpu/kernels/cross_entropy.py:154"),
    "fused_cross_entropy_bwd": ("paddle_tpu_torch/csrc/cross_entropy.cu",
                                "paddle_tpu/kernels/cross_entropy.py:178"),
    # upstream flash with SegmentIds (the call at l.333; packed, l.447):
    # padding_mask= and flash_attention_packed, forward, dkv and dq (the
    # wgmma core in bf16, its 3xTF32 form in f32)
    "flash_attention_seg_fwd": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                                "paddle_tpu/kernels/flash_attention.py:333"),
    "flash_attention_seg_dkv": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                                "paddle_tpu/kernels/flash_attention.py:333"),
    "flash_attention_seg_dq": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                               "paddle_tpu/kernels/flash_attention.py:333"),
    # the block-stats kernel (ring attention's per-round compute; no
    # longer on the biased route), held in the kernel phase: bf16, the
    # entry's route, in flash_wgmma.cu's STATS mode; f32 (the entry's
    # `sdpa_bias_f32`) on block_attention.cu's SIMT kernel
    "block_attention_stats": ("paddle_tpu_torch/csrc/flash_wgmma.cu",
                              "paddle_tpu/kernels/block_attention.py:138"),
    # flash_attention_biased: one fused biased forward, dkv and dq on the
    # flash core (the reference runs the block-stats kernel per chunk)
    "flash_attention_bias_fwd": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                 "paddle_tpu/kernels/flash_attention.py:215"),
    "flash_attention_bias_dkv": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                 "paddle_tpu/kernels/flash_attention.py:215"),
    "flash_attention_bias_dq": ("paddle_tpu_torch/csrc/flash_attention.cu",
                                "paddle_tpu/kernels/flash_attention.py:215"),
    # no pallas_call: the reference's int8 dequant, which XLA fuses into
    # the dot's operand read (`_dequant_state`); incubate's
    # weight_only_linear (incubate/nn/functional/__init__.py:352)
    "weight_only_linear": ("paddle_tpu_torch/csrc/weight_only_linear.cu",
                           "paddle_tpu/inference/serving.py:263"),
}
# the training phase: bench.py's accelerator configuration
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
# A 2-layer full-width llama_1b, one forward/backward on the kernel
# route against the plain route (`plain_routes`, SwiGLU in f32): |loss
# difference| / |loss|, and the largest per-parameter relative L2 error
# of the grads. The routes differ by bf16 roundings (the kernels round P,
# dS, dg and du for their tensor-core products; the plain route keeps
# them f32). The first reading on an H100 was 6.28e-6 on the loss and
# 0.0106 (embed_tokens) on the grads; the limits are about twice that.
TRAIN_LOSS_RTOL = 1.5e-5
TRAIN_GRAD_RTOL = 0.025
# the 7B training phase: bench.py's 7B configuration (remat on by
# default, bench.py:515-516), fused cross-entropy, one card
TRAIN7B_WARMUP, TRAIN7B_STEPS = 2, 3
# A 2-layer full-width llama_7b, one forward/backward on the kernel route
# (remat "save_matmul_outputs", fused cross-entropy) against the plain
# route (`plain_routes`): the same measures and the same limits as the
# llama_1b check above.
TRAIN7B_LOSS_RTOL = 1.5e-5
TRAIN7B_GRAD_RTOL = 0.025


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


# `traced_device_ms`'s marker: torch.cuda._sleep's kernel, about 50 us
# long, MARKER_LEAD of them before the calls; TRACE_SETTLE_S seconds of
# host sleep open each window before them
MARKER_KERNEL = "spin_kernel"
MARKER_CYCLES = 100000
MARKER_LEAD = 8
TRACE_SETTLE_S = 0.05


def traced_device_ms(fn, iters=10, kernel=None, attempts=3):
    """The card's own time for one call of fn: the summed device time of
    the CUDA kernels it runs, traced by torch.profiler over `iters` calls
    after one warm-up call, divided by iters. Beside `time_ms`, which the
    host bounds where a call enqueues many small launches (SDPA's
    backward through autograd at BERT's width), it says what the card
    spends. With `kernel` (a name fragment of the one kernel a call
    launches) the trace must hold exactly `iters` launches of it: a trace
    that lost events is taken again, up to `attempts` times, and then
    fails. Late in a long run a trace has dropped the first few records
    of its window (1-3 kernels, up to ~300 us of card time, at every
    attempt): `MARKER_LEAD` marker kernels lead each window and one
    closes it, and their time stays out of the sum. A trace has also
    lost its markers and the first 3-5 of ten 0.6 ms launches, about
    2-3 ms of card time after the window opened, at every attempt: the
    window now opens with `TRACE_SETTLE_S` of host sleep before any
    launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # marker kernels (`MARKER_KERNEL`, outside the sums) lead the
            # calls and close them: a long process's traces have been seen
            # to drop the first few records of their window (PERF.md §6)
            time.sleep(TRACE_SETTLE_S)
            for _ in range(MARKER_LEAD):
                torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        sums, _ = _device_ms(prof, ((MARKER_KERNEL, "marker"),), "all")
        if kernel is None:
            break
        cuda = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        n = sum(c for key, c in cuda if kernel in key)
        if n == iters:
            break
        line = sorted((e.time_range.start, e.name[:40])
                      for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        t0 = line[0][0] if line else 0
        print(f"traced_device_ms: {n} launches of {kernel} traced of "
              f"{iters} (the trace's kernels: "
              f"{[(key[:70], c) for key, c in cuda]}; their starts, us: "
              f"{[(round(t - t0, 1), name) for t, name in line]}); "
              f"tracing again", flush=True)
    else:
        check(False, f"traced_device_ms: the trace never held {iters} "
                     f"launches of {kernel}")
    return sums.get("all", 0.0) / iters


def bound_ms(nbytes, flops, dtype_name):
    """The least time for the work: bytes over the HBM rate against
    operations over the peak rate for `dtype_name` (bf16, tf32: tensor
    cores; float32: f32 outside them, for elementwise work)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ragged paged attention's cases, (q_start, q_len, kv_len) per slot:
# "mixed" is a prefill chunk deep in a 700-token prompt, a decode row at
# 300, an idle slot and a fresh 64-token prefill, plus 3 padding rows;
# "decode_only" the ragged burst's steady state after its prefills end,
# four decode rows at 18/101/301/701 keys and 124 padding rows; "verify"
# a speculative step of the same burst, four entries of a decode row and
# 4 drafts at 22/105/305/705 keys and 108 padding rows. The speculative
# engine flags every decode and verify entry in `row_tiles`
# (`ROW_TILED`).
RAGGED_ROWS = {"mixed": [(0, 60, 700), (60, 1, 300), (0, 0, 0),
                         (61, 64, 64)],
               "decode_only": [(0, 1, 18), (1, 1, 101), (2, 1, 301),
                               (3, 1, 701)],
               "verify": [(0, 5, 22), (5, 5, 105), (10, 5, 305),
                          (15, 5, 705)]}
ROW_TILED = ("decode_only", "verify")


def row_tiles_for(torch, tag, rows):
    """The `row_tiles` flags the speculative engine passes at one of
    `RAGGED_ROWS`: every decode and verify entry, i32[B] on the card;
    None for the mixed step's case."""
    if tag not in ROW_TILED:
        return None
    return torch.ones(len(rows), dtype=torch.int32, device="cuda")


def ragged_case(torch, dtype, gen, rows=RAGGED_ROWS["mixed"]):
    """The slice's attention shapes: T=128 packed rows, 32 heads of 128,
    pages of 16, 64 pages per sequence, 4 slots (`RAGGED_ROWS`)."""
    T, nh, d, page, B, ppmax = 128, 32, 128, 16, 4, 64
    n_pages = B * ppmax + 1
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


def compare(name, dname, pairs, tag=""):
    """Hold each kernel output against its plain version element by
    element: |kernel - plain| <= atol + rtol * |plain|. pairs: [(label,
    kernel output, plain output[, sum of |terms|])], limited by `TOL`
    (atol TERMS: testing.TERM_FRAC of the element's sum of |terms|), or
    [(label, kernel, plain, atol, rtol)] carrying their own limit, atol a
    number or a tensor shaped like plain. tag names the case in the
    printout. Returns the largest |kernel - plain|."""
    import torch

    from paddle_tpu_torch import testing
    errs = []
    for label, out, ref, *extra in pairs:
        if len(extra) == 2:
            atol, rtol = extra
        else:
            atol, rtol = TOL.get((f"{name}.{label}", dname),
                                 TOL.get((name, dname)))
            if atol == TERMS:
                frac = testing.TERM_FRAC[getattr(torch, dname)]
                atol = frac * extra[0]
        if torch.is_tensor(atol):
            limit = f"max {atol.max().item():.6g}"
        else:
            limit = f"{atol:g}"
        err = (out.double() - ref.double()).abs().max().item()
        worst = testing.worst(out, ref, atol, rtol)
        ok = worst <= 1.0
        print(f"kernel {name} {dname} {label}{tag}: max_abs_err={err:.6g} "
              f"worst err/limit={worst:.6g} (limit {limit} + "
              f"{rtol:g}*|plain|, max|plain| {ref.abs().max().item():.6g}) "
              f"{'ok' if ok else 'MISS'}", flush=True)
        check(ok, f"{name} {dname} {label}{tag} disagrees with its plain "
                  f"version")
        errs.append(err)
    return max(errs)


def timed(name, err, fn_kernel, fn_plain, nbytes, flops, library=None,
          iters=50, plain_iters=None, tag="", ops_dtype="bfloat16",
          dname="bf16"):
    """One kernel's measurements (bf16 unless dname says otherwise):
    kernel, plain version and library call by CUDA events, the bound
    from this run's shapes (its operations at the peak rate of
    `ops_dtype`)."""
    ms = time_ms(fn_kernel, iters)
    plain_ms = time_ms(fn_plain, plain_iters or max(iters // 5, 3))
    with warnings.catch_warnings():
        # F.rms_norm with a f32 weight on bf16 rows warns that it takes
        # its unfused path — that path is what is timed
        warnings.simplefilter("ignore", UserWarning)
        lib_ms = time_ms(library, iters) if library else None
    b_ms, b_by = bound_ms(nbytes, flops, ops_dtype)
    print(f"kernel {name} {dname}{tag}: kernel_ms={ms:.6g} "
          f"plain_ms={plain_ms:.6g} "
          f"library_ms={'none' if lib_ms is None else f'{lib_ms:.6g}'} "
          f"bound_ms={b_ms:.6g} ({b_by})", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def timed_3xtf32(name, err, fn_kernel, fn_plain, nbytes, flops, **kw):
    """`timed` for an f32 flash kernel, bound where the card does f32
    products fastest at f32 accuracy: in 3xTF32 on the tensor cores, as
    csrc/flash_wgmma.cu runs them (the f32 bias forward, on SIMT, is
    bound the same way). bound_ms, and its copy `bound_3xtf32_ms`,
    counts three tf32 products a product at the tf32 rate;
    `bound_simt_ms` keeps one f32 product at the f32 rate outside the
    tensor cores beside it. flops: one product's work."""
    m = timed(name, err, fn_kernel, fn_plain, nbytes, 3 * flops,
              ops_dtype="tf32", dname="f32", **kw)
    m["bound_3xtf32_ms"] = m["bound_ms"]
    m["bound_simt_ms"] = bound_ms(nbytes, flops, "float32")[0]
    return m


def entry(name, measured):
    src, replaces = SOURCES[name]
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": None, **measured}


def add_launches(report, name, path, n):
    """Record one path's launch count; `launches` is the sum over the
    paths that ran the kernel."""
    e = report[name]
    e.setdefault("launches_by_path", {})[path] = n
    e["launches"] = sum(e["launches_by_path"].values())


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
                 library=None, iters=50, tag="", time_it=True):
            """fn_plain: the plain version as the port runs it (timed);
            fn_f32: the same on f32 copies of the inputs, held against
            the bf16 kernel (f32: fn_plain itself). Returns the bf16
            measurements (None for f32, or when not time_it)."""
            out = fn_kernel()
            torch.cuda.synchronize()
            ref = (fn_plain if dtype == torch.float32 else fn_f32)()
            torch.cuda.synchronize()
            err = compare(name, dname, [("out", out, ref)], tag)
            if dtype != torch.bfloat16 or not time_it:
                return None
            return timed(name, err, fn_kernel, fn_plain, nbytes, flops,
                         library, iters, tag=tag)

        # rms_norm and swiglu at every row count the main path gives
        # them: the ragged serving step's 128 packed rows at llama_7b's
        # width (timed: the kernel table's row), the decode step's 4 (B =
        # 4 in generate and the bucketed engine; timed), the training
        # slices' 8192 rows at llama_1b's and at llama_7b's width (timed),
        # the bucketed prefills' 32 (bucket 32 x 1) and 2048 (bucket 1024
        # x 2) and generate's prefill 512 (4 x 128), checked only. 128
        # rows also stand for the bucketed prefill of bucket 128 x 1. The
        # bytes-bound row counts go first: a run of dense 8192-row
        # products leaves the card at a lower clock for a while.
        shapes = ((128, 4096, 11008, "serving"),
                  (4, 4096, 11008, "decode"),
                  (8192, 2048, 5504, "training"),
                  (8192, 4096, 11008, "training_7b"),
                  (32, 4096, 11008, None),
                  (512, 4096, 11008, None), (2048, 4096, 11008, None))
        for rows, H, _, path in shapes:
            x = torch.randn((rows, H), generator=gen, device="cuda").to(dtype)
            w = 1 + 0.1 * torch.randn((H,), generator=gen, device="cuda")
            m = held("rms_norm",
                     lambda: krn.rms_norm(x, w, eps, use_kernel=True),
                     lambda: krn._plain(x, w, eps),
                     lambda: krn._plain(x.float(), w, eps),
                     nbytes=2 * x.numel() * it + w.numel() * 4,
                     flops=4 * x.numel(),
                     library=lambda: F.rms_norm(x, (H,), w, eps),
                     tag=f" [{rows}x{H}]", time_it=path is not None)
            if m:
                # beside the event time: the card's own time of one call
                # (each trace held to its launches and to the bound) and
                # the host's time to enqueue one
                m.update(split_times(
                    lambda: krn.rms_norm(x, w, eps, use_kernel=True),
                    RMS_KERNEL, m["bound_ms"],
                    f"rms_norm bf16 [{rows}x{H}]"))
                if path == "serving":
                    report["rms_norm"] = entry("rms_norm", m)
                else:
                    report["rms_norm"][path] = m

        # swiglu: a [rows, H] @ w_gate_up [H, 2M]
        for T, H, M, path in shapes:
            a = torch.randn((T, H), generator=gen, device="cuda").to(dtype)
            wgu = (0.02 * torch.randn((H, 2 * M), generator=gen,
                                      device="cuda")).to(dtype)
            m = held("swiglu",
                     lambda: ksw.swiglu(a, wgu, use_kernel=True),
                     lambda: ksw._ref(a, wgu),
                     lambda: ksw._ref(a.float(), wgu.float()),
                     nbytes=(a.numel() + wgu.numel() + T * M) * it,
                     flops=2 * T * H * 2 * M,
                     tag=f" [{T}x{H} @ {H}x{2 * M}]",
                     time_it=path is not None)
            if m and path == "serving":
                report["swiglu"] = entry("swiglu", m)
            elif m:
                report["swiglu"][path] = m
            del wgu
        if dtype == torch.bfloat16:
            for T, H, M in SWIGLU_ROUTE_SHAPES:
                swiglu_route_check(T, H, M)

        # ragged paged attention at the slice's shapes
        for tag, rows in RAGGED_ROWS.items():
            ragged_kernel(report, dtype, dname, gen, tag, rows)
        paged_kernels(report, dtype)
        if dtype == torch.bfloat16:
            split_sweep(report)
        training_kernels(report, dtype, gen)
        torch.cuda.empty_cache()
        attention_kernels(report, dtype)
    w8a16_kernels(report)
    torch.cuda.empty_cache()


def w8a16_kernels(report):
    """Row 14 at llama_7b's quantized serving products
    (`testing.W8A16_SHAPES`, per-column scales as the engine quantizes),
    bf16: each at 128 rows (the ragged step's packed rows), 4 (decode,
    the lm head) and 512 (a bucketed prefill) held against its plain
    version (`testing.W8A16_LIMIT`); at 128 and 4 rows timed beside the
    plain route (dequantize, then cuBLAS), the bound (the int8 weight,
    its scales and the activations read once, the output written once,
    over 3.35 TB/s; or 2MKN over 989 TFLOP/s), the library call
    `torch._weight_int8pack_mm` where this PyTorch runs it on the card
    (none for the SwiGLU epilogue, which no one call computes), and
    bf16 cuBLAS over the already dequantized weight
    (`dequant_cublas_ms`: what bf16 weights cost the same product), with
    the card's own time (`device_ms`, traced) and the wrapper's enqueue
    (`host_us`) beside the events; then each product's rows bitwise
    their 1-row products at 128 rows and at both sides of every switch
    of the kernel's plan, 512 included."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.kernels import weight_only_linear as kwol

    for name, (K, N, gu) in testing.W8A16_SHAPES.items():
        for M in (128, 4, 512):
            a, q, s = testing.w8a16_case(M, K, N, seed=M)
            out, ref, atol = testing.w8a16_pair(a, q, s, swiglu=gu)
            torch.cuda.synchronize()
            tag = f" {name} [{M}x{K} @ {K}x{N}{' swiglu' if gu else ''}]"
            err = compare("weight_only_linear", "bfloat16",
                          [("out", out, ref, atol, testing.W8A16_LIMIT[1])],
                          tag)
            path = {128: "serving", 4: "decode"}.get(M)
            if path is None:
                continue
            n_out = N // 2 if gu else N
            nbytes = q.numel() + 4 * s.numel() + 2 * (a.numel() + M * n_out)
            library = None
            if not gu and hasattr(torch, "_weight_int8pack_mm"):
                qt = q.t().contiguous()
                sb = s.reshape(-1).to(torch.bfloat16)
                try:
                    torch._weight_int8pack_mm(a, qt, sb)
                    torch.cuda.synchronize()
                    library = (lambda a=a, qt=qt, sb=sb:
                               torch._weight_int8pack_mm(a, qt, sb))
                except RuntimeError as e:
                    print(f"kernel weight_only_linear{tag}: "
                          f"torch._weight_int8pack_mm does not run here "
                          f"({str(e)[:120]}): library_ms none", flush=True)

            def call(a=a, q=q, s=s, gu=gu):
                return kwol.weight_only_linear(a, q, s, swiglu=gu,
                                               use_kernel=True)

            m = timed("weight_only_linear", err, call,
                      lambda: kwol._plain(a, q, s, None, gu),
                      nbytes, 2 * M * K * N, library=library, tag=tag)
            w = kwol.dequantize(q, s, torch.bfloat16)
            cublas = (lambda: ksw._ref(a, w)) if gu else (lambda: a @ w)
            m["dequant_cublas_ms"] = time_ms(cublas, 50)
            m["device_ms"] = traced_device_ms(call, kernel="w8a16_kernel")
            m["dequant_cublas_device_ms"] = traced_device_ms(cublas)
            m["host_us"] = host_us(call)
            p = kwol.plan(M, K, N, gu)
            m["splits"], m["route"], m["n"] = p.splits, p.route, p.n
            print(f"kernel weight_only_linear{tag}: dequant_cublas_ms="
                  f"{m['dequant_cublas_ms']:.6g} (bf16 cuBLAS over the "
                  f"dequantized weight; device "
                  f"{m['dequant_cublas_device_ms']:.6g}) device_ms="
                  f"{m['device_ms']:.6g} host_us={m['host_us']:.6g} "
                  f"S={p.splits} route={p.route} n={p.n}", flush=True)
            if name == "qkv" and path == "serving":
                report["weight_only_linear"] = entry("weight_only_linear", m)
            else:
                report["weight_only_linear"][f"{path}_{name}"] = m
            del w
        for M in (128, *testing.w8a16_switch_rows(K, N, gu)):
            a, q, s = testing.w8a16_case(M, K, N, seed=3)
            same = testing.w8a16_rows_independent(a, q, s, gu)
            print(f"kernel weight_only_linear {name}: {same}/{M} rows "
                  f"bitwise their 1-row products (plan "
                  f"{kwol.plan(M, K, N, gu).route}, n "
                  f"{kwol.plan(M, K, N, gu).n})", flush=True)
            check(same == M, f"weight_only_linear {name}: a row of {M} "
                  f"depends on the product's other rows")


def ragged_kernel(report, dtype, dname, gen, tag, rows):
    """ragged_paged_attention at one of `RAGGED_ROWS`, checked against its
    plain version; bf16 timed by events and by the card's own time, each
    call on its own copy of the pools (`pool_copies`)."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa

    args, _ = ragged_case(torch, dtype, gen, rows)
    q = args[0]
    scale = 1.0 / q.shape[2] ** 0.5
    flags = row_tiles_for(torch, tag, rows)
    out = krpa.ragged_paged_attention(*args, use_kernel=True,
                                      row_tiles=flags)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        ref = krpa._dense_fallback((q * scale).float(), args[1].float(),
                                   args[2].float(), *args[3:], 1.0)
    else:
        ref = krpa._dense_fallback(*args, scale)
    err = compare("ragged_paged_attention", dname, [("out", out, ref)],
                  f" [{tag}]")
    del out, ref
    bitwise = None
    if tag == "verify":
        # each verify row against the same row launched alone as a decode
        # row (the kill switch's launch) over the same pool; without row
        # tiles for the record
        same, n = testing.verify_bitwise(krpa.ragged_paged_attention, args,
                                         flags)
        plain_same, _ = testing.verify_bitwise(
            krpa.ragged_paged_attention, args)
        bitwise = {"rows": n, "equal": same, "equal_without_row_tiles":
                   plain_same}
        print(f"kernel ragged_paged_attention {dname} [verify]: rows equal "
              f"to their decode rows under torch.equal {same}/{n} "
              f"(without row tiles {plain_same}/{n}) "
              f"{'ok' if same == n else 'MISS'}", flush=True)
        check(same == n, f"ragged_paged_attention {dname}: {n - same} "
              f"verify rows differ from their decode rows")
    if dtype != torch.bfloat16:
        return
    call = ragged_call(krpa, args, row_tiles=flags)
    m = timed("ragged_paged_attention", err, call,
              lambda: krpa._dense_fallback(*args, scale),
              *ragged_work(args, rows), iters=100, tag=f" [{tag}]")
    m["device_ms"] = held_device_ms(call, RAGGED_KERNEL, m["bound_ms"],
                                    f"ragged_paged_attention [{tag}]")
    m["row_tiles"] = flags is not None
    if bitwise:
        m["bitwise_decode_rows"] = bitwise
    if flags is not None:
        # the same case without row tiles: what the design costs
        m["device_ms_without_row_tiles"] = held_device_ms(
            ragged_call(krpa, args), RAGGED_KERNEL, m["bound_ms"],
            f"ragged_paged_attention [{tag}] without row tiles")
    if tag == "mixed":
        report["ragged_paged_attention"] = entry("ragged_paged_attention",
                                                 m)
    else:
        report["ragged_paged_attention"][tag] = m


# the device kernels of rows 9 and 13 (one launch a call, no other
# kernel): `traced_device_ms` counts their launches
RAGGED_KERNEL = "ragged_paged_attention_kernel"
PAGED_KERNEL = "paged_decode_kernel"
# rows 1 and 8 (a fragment the parent's kernels share: `--ab ... norm`)
RMS_KERNEL = "rms_norm_kernel"
STATS_KERNEL = "block_stats_"


def ragged_work(args, rows):
    """(bytes, flops) that ragged paged attention must spend at one of
    `RAGGED_ROWS`: q of the rows a sequence owns read once (the kernel
    reads no padding row), every row of out written once, each sequence's
    K and V rows up to kv_len read once, the metadata; 4 d flops a head
    per (row, key) under the causal limit."""
    q = args[0]
    T, nh, d = q.shape
    it = q.element_size()
    owned = sum(ql for _, ql, _ in rows)
    kv_tokens = sum(kl for _, _, kl in rows)
    nbytes = ((owned + T) * nh * d * it + 2 * kv_tokens * nh * d * it
              + sum(m.numel() * 4 for m in args[3:]))
    flops = sum(4 * (kl - ql + t + 1) * d * nh
                for _, ql, kl in rows for t in range(ql))
    return nbytes, flops


def paged_work(args):
    """(bytes, flops) that paged decode attention must spend: the live K
    and V rows once, q and out once, lengths and table; 4 d flops a q
    head per live key."""
    q, kp, _, lens, pt = args
    nh, d = q.shape[1], q.shape[2]
    kvh, it = kp.shape[0], q.element_size()
    live = int(lens.sum())
    return (2 * live * kvh * d * it + 2 * q.numel() * it
            + lens.numel() * 4 + pt.numel() * 4), 4 * live * nh * d


def split_times(call, kernel, bound, what):
    """Rows 1 and 8's readings beside the event time: `device_ms`, the
    card's own time of one call (`held_device_ms`: each trace holds its
    launches of `kernel` and reads at or above `bound`), and `host_us`,
    the host's time to enqueue one, the call under `torch.no_grad` as
    the serving steps run it."""
    import torch
    with torch.no_grad():
        out = {"device_ms": held_device_ms(call, kernel, bound, what),
               "host_us": host_us(call)}
    print(f"kernel {what}: host_us={out['host_us']:.6g}", flush=True)
    return out


def held_device_ms(call, kernel, bound, what):
    """`traced_device_ms` of one call of a paged kernel (40 calls, each
    launch of `kernel` counted), failing below the call's bound: a
    reading under the bound lost events or miscounts the work."""
    ms = traced_device_ms(call, 40, kernel=kernel)
    print(f"kernel {what}: device_ms={ms:.6g} (bound {bound:.6g})",
          flush=True)
    check(ms >= bound, f"{what}: device_ms {ms:.6g} below its bound "
                       f"{bound:.6g}")
    return ms


# split sizes (keys) the sweep times beside the one in use
# (`_paged_split.SPLIT_KEYS`, shared by rows 13 and 9): paged decode at
# the bucketed engine's case and at generate's cache, ragged attention at
# its decode-only and mixed cases
SPLIT_SWEEP = (64, 128, 256, 512)


def split_sweep(report):
    """The card's own time of rows 13 and 9 at each of `SPLIT_SWEEP`'s
    split sizes (`_paged_split.SPLIT_KEYS` set for the sweep and
    restored), each call on its own copy of the pools, each point held to
    its launch count and bound (`held_device_ms`): how the split size was
    chosen. Recorded as the entries' `split_sweep`."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import _paged_split
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa

    def sweep(name, call, kernel, work, tag):
        saved = _paged_split.SPLIT_KEYS
        bound = bound_ms(*work, "bfloat16")[0]
        got = {}
        try:
            for sk in SPLIT_SWEEP:
                _paged_split.SPLIT_KEYS = sk
                got[sk] = held_device_ms(call, kernel, bound,
                                         f"{name} [{tag}] at {sk} keys")
        finally:
            _paged_split.SPLIT_KEYS = saved
        print(f"split sweep {name} [{tag}] (device ms; SPLIT_KEYS in use "
              f"{saved}): " + " ".join(f"{k}={v:.6g}" for k, v in
                                       got.items()), flush=True)
        return got

    got = {}
    for tag, args in testing.paged_decode_cases(
            torch.bfloat16, tags=("engine", "generate_cache")):
        got[tag] = sweep("paged_decode_attention", paged_call(kpa, args),
                         PAGED_KERNEL, paged_work(args), tag)
    report["paged_decode_attention"]["split_sweep"] = got
    gen = torch.Generator(device="cuda").manual_seed(1234)
    got = {}
    for tag in ("decode_only", "mixed"):
        args, rows = ragged_case(torch, torch.bfloat16, gen,
                                 RAGGED_ROWS[tag])
        got[tag] = sweep("ragged_paged_attention", ragged_call(krpa, args),
                         RAGGED_KERNEL, ragged_work(args, rows), tag)
    report["ragged_paged_attention"]["split_sweep"] = got
    torch.cuda.empty_cache()


def pool_copies(args, n=8):
    """n argument tuples of a paged kernel, the first `args` itself and
    each other with its own clone of the K and V pools (args[1], args[2];
    a clone keeps a strided view's strides): calls that take them in turn
    find their pages cold in the 50 MB L2, as each layer's call does on
    the main path."""
    return [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                     for _ in range(n - 1)]


def cold_calls(fn, argsets):
    """A call of fn on the next of argsets, in turn."""
    turn = [0]

    def call():
        a = argsets[turn[0] % len(argsets)]
        turn[0] += 1
        return fn(*a)

    return call


def ragged_call(krpa, args, **kw):
    return cold_calls(lambda *a: krpa.ragged_paged_attention(
        *a, use_kernel=True, **kw), pool_copies(args))


def paged_call(kpa, args):
    return cold_calls(lambda *a: kpa.paged_decode_attention(
        *a, use_kernel=True), pool_copies(args))


def paged_kernels(report, dtype):
    """paged_decode_attention at `testing.PAGED_DECODE_CASES`: (a) the
    bucketed engine's llama_7b decode, q [4, 32, 128], pool [32, 257, 16,
    128], shuffled block table [4, 64], lengths 17/100/300/700 (timed in
    bf16); (b) generate's cache read through paginate_cache's strided
    views, at the generate phase's own [4, 192, 32, 128] per layer and
    at [4, 1024, 32, 128]; (c) GQA 32/8, d = 64 (GQA 8/2, pages of 8)
    and one sequence of 1000 (checked only)."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import paged_attention as kpa

    dname = str(dtype).split(".")[1]
    check(testing.PAGED_DECODE_CASES["generate_cache"][1]["S"]
          == -(-(GEN_PROMPT + GEN_NEW) // 16) * 16,
          "the generate_cache case is not the generate phase's cache")
    errs = {}
    for tag, args in testing.paged_decode_cases(dtype):
        out, ref = testing.paged_decode_pair(*args)
        errs[tag] = compare("paged_decode_attention", dname,
                            [("out", out, ref)], f" [{tag}]")
        del args, out, ref
    if dtype != torch.bfloat16:
        return
    # (a) and generate's own cache, timed by events and by the card's own
    # time: each call takes the next of 8 copies of the pool (the engine
    # case's are 146 MB of live pages against the 50 MB L2), so each
    # launch finds its pages cold, as each layer's launch does
    for tag in ("engine", "generate_cache"):
        ((_, args),) = testing.paged_decode_cases(dtype, tags=(tag,))
        q, kp, vp, lens, pt = args
        B, _, d = q.shape
        kvh, _, page, _ = kp.shape
        scale = 1.0 / d ** 0.5
        # the library yardstick: SDPA on q [B, nh, 1, d] against the
        # contiguous K/V [B, nh, S, d] with a boolean length mask
        S = pt.shape[1] * page
        kc, vc = (torch.movedim(x[:, pt.long()], 0, 1).reshape(B, kvh, S, d)
                  for x in (kp, vp))
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        call = paged_call(kpa, args)
        m = timed(
            "paged_decode_attention", errs[tag], call,
            lambda: kpa._plain(q, kp, vp, lens, pt, scale),
            *paged_work(args),
            library=lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask),
            iters=200, tag=f" [{tag}]")
        m["device_ms"] = held_device_ms(call, PAGED_KERNEL, m["bound_ms"],
                                        f"paged_decode_attention [{tag}]")
        if tag == "engine":
            report["paged_decode_attention"] = entry(
                "paged_decode_attention", m)
        else:
            report["paged_decode_attention"][tag] = m
        del call, kc, vc, args, kp, vp
        torch.cuda.empty_cache()


# The SwiGLU bf16 products' two cores in csrc/swiglu.cu, told apart by
# their device kernels' names: the wgmma/TMA core (name fragment
# WGMMA_KERNEL) and the mma.sync kernel. The template arguments <TA, TB,
# GU, epilogue> name the product: FwdEpi the forward, DguEpi the g/u
# recompute of swiglu_bwd_da, StoreEpi with TA its da product (TB) or
# swiglu_bwd_dw's a^T dgu (TA).
WGMMA_KERNEL = "wgmma_swiglu_kernel"
_SWIGLU_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])(wgmma_swiglu_kernel|mma_kernel)<(true|false), "
    r"(true|false), (true|false), [^>]*?(FwdEpi|DguEpi|StoreEpi)")
# the 7B training shape (every product on the wgmma core) and the card
# tests' scalar_edges shape (H = 100: a's rows are not whole 16-byte
# vectors, so only da, whose rows are 2M = 120 long, takes the core)
SWIGLU_ROUTE_SHAPES = ((8192, 4096, 11008), (77, 100, 60))


def swiglu_route_of(name):
    """(product, core) of a SwiGLU bf16 device kernel's name, or None:
    product forward, recompute, da or dw; core "wgmma" or "mma.sync"."""
    m = _SWIGLU_KERNEL.search(name)
    if m is None:
        return None
    core = "wgmma" if m.group(1) == WGMMA_KERNEL else "mma.sync"
    product = {"FwdEpi": "forward", "DguEpi": "recompute"}.get(
        m.group(5), "dw" if m.group(2) == "true" else "da")
    return product, core


def expected_swiglu_routes(T, H, M):
    """The core each bf16 product of a [T, H] @ [H, 2M] SwiGLU takes by
    csrc/swiglu.cu's one test (torch's allocations are 16-byte aligned):
    the wgmma core where every operand row is whole 16-byte vectors, the
    mma.sync kernel where one is not, and for the forward at T <= 128
    rows (SMALL_T)."""
    def core(*rows):
        return "wgmma" if all(r % 8 == 0 for r in rows) else "mma.sync"
    return {"forward": core(H, M) if T > 128 else "mma.sync",
            "recompute": core(H, M), "da": core(2 * M), "dw": core(H, 2 * M)}


def device_trace(run, complete=None, attempts=3):
    """torch.profiler's CUDA trace of `run()`, taken again (up to
    `attempts` times, after `TRACE_SETTLE_S` of host sleep) while it
    holds no device kernel at all or `complete(prof)` says a launch is
    missing from it: traces on the card have come back empty, and
    without the backward's kernels of a forward and backward. A trace
    that lost nothing is returned as it is; so is the last attempt."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            run()
            torch.cuda.synchronize()
        if (any(e.device_type == DeviceType.CUDA
                for e in prof.key_averages())
                and (complete is None or complete(prof))):
            break
        print(f"device trace: a launch is missing from the trace (attempt "
              f"{i + 1} of {attempts}), tracing again", flush=True)
    return prof


def swiglu_route_check(T, H, M):
    """Trace one swiglu forward, one swiglu_bwd_da and one swiglu_bwd_dw in
    bf16 and hold the cores their device kernels name against
    `expected_swiglu_routes`: at the 7B shape no mma_kernel may run and
    every product must be a WGMMA_KERNEL launch."""
    import torch
    from torch.autograd import DeviceType

    from paddle_tpu_torch.kernels import swiglu as ksw
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen,
                                  device="cuda")).bfloat16()

    a, wgu, do = rand(T, H), rand(H, 2 * M, std=0.02), rand(T, M)

    def run():
        ksw.swiglu(a, wgu, use_kernel=True)
        _, dgu = ksw.swiglu_bwd_da(a, wgu, do)
        ksw.swiglu_bwd_dw(a, dgu)

    def read(prof):
        got = {}
        for e in prof.key_averages():
            route = (swiglu_route_of(e.key)
                     if e.device_type == DeviceType.CUDA else None)
            if route:
                got.setdefault(route[0], set()).add(route[1])
        return got

    want = expected_swiglu_routes(T, H, M)
    got = read(device_trace(run, lambda p: set(want) <= set(read(p))))
    tag = f"[{T}x{H} @ {H}x{2 * M}]"
    print(f"swiglu route {tag}: " + " ".join(
        f"{p}={'+'.join(sorted(got.get(p, ()))) or 'none'}" for p in want)
        + f" (want {want}; wgmma kernel name fragment '{WGMMA_KERNEL}')",
        flush=True)
    check(got == {p: {c} for p, c in want.items()},
          f"swiglu {tag}: the products ran on {got}, not {want}")
    del a, wgu, do


# Flash attention's cores, told apart by their device kernels' names:
# flash_{fwd,bwd_dkv,bwd_dq}_{wgmma,tf32,mma,simt}_kernel
# (csrc/flash_wgmma.cu: the TMA + wgmma core and its 3xTF32 f32 form;
# csrc/flash_attention.cu: the bias route's mma.sync and SIMT kernels)
# and the backward's pre-pass flash_delta_kernel.
_FLASH_KERNEL = re.compile(
    r"(?<![A-Za-z0-9_])flash_(?:(fwd|bwd_dkv|bwd_dq)_(wgmma|tf32|mma|simt)|"
    r"(delta))_kernel<")
# the element checks beside the training shapes: GQA causal, head dim
# 64 full, and a ragged S (1000: not a multiple of any tile) both ways
FLASH_SMALL_CASES = ((2, 256, 8, 2, 128, True), (2, 256, 4, 4, 64, False),
                     (1, 1000, 4, 4, 128, True), (2, 1000, 4, 2, 64, False))
# (B, S, Hq, Hk, D, causal) the route check traces: llama_7b's and
# llama_1b's training shapes, then FLASH_SMALL_CASES
FLASH_ROUTE_CASES = ((4, 2048, 32, 32, 128, True),
                     (4, 2048, 16, 16, 128, True)) + FLASH_SMALL_CASES


def flash_route_of(name):
    """(launch, core) of a flash device kernel's name, or None: launch
    forward, dkv, dq or delta; core "wgmma", "wgmma-tf32" (the f32
    kernels of the one-length and segment routes), "mma.sync" or "simt"
    (the delta pre-pass is a SIMT kernel)."""
    m = _FLASH_KERNEL.search(name)
    if m is None:
        return None
    if m.group(3):
        return "delta", "simt"
    launch = {"fwd": "forward", "bwd_dkv": "dkv", "bwd_dq": "dq"}[m.group(1)]
    return launch, {"mma": "mma.sync", "tf32": "wgmma-tf32"}.get(
        m.group(2), m.group(2))


def expected_flash_routes(B, S, Hq, Hk, D, causal, dtype):
    """The core each launch of `flash_attention_fwd` and
    `flash_attention_bwd` takes for q [B, S, Hq, D] and k/v [B, S, Hk,
    D]: every bf16 call runs the wgmma core (the entries take no segment
    ids, no bias and one length), every f32 call its 3xTF32 form; the
    backward's delta pre-pass is a SIMT kernel in both. Raises ValueError
    for a shape the entries do not take."""
    if not (B > 0 and S > 0 and Hk > 0 and Hq % Hk == 0 and D in (64, 128)):
        raise ValueError(f"flash takes no [B{B} S{S} H{Hq}/{Hk} D{D}]")
    dname = str(dtype).split(".")[-1]
    core = {"bfloat16": "wgmma", "float32": "wgmma-tf32"}[dname]
    del causal  # causal or full: the same kernels
    return {"forward": core, "dkv": core, "dq": core, "delta": "simt"}


def traced_flash_routes(run, launches=()):
    """Trace `run()` twice (a trace can miss a kernel that starts at the
    very edge of its window: a single forward launched first read as
    absent on an H100), taken again while one of `launches` (forward,
    dkv, dq, delta) is absent from it, and return ({launch: {cores}} of
    the flash device kernels it ran, every device kernel's name). A
    launch on the wrong core is no absence: the caller's check fails."""
    def twice():
        for _ in range(2):
            run()

    prof = device_trace(twice, lambda p: set(launches)
                        <= set(flash_routes_of(p)[0]))
    return flash_routes_of(prof)


def flash_routes_of(prof):
    """({launch: {cores}} of the flash device kernels in a torch.profiler
    trace, every device kernel's name)."""
    from torch.autograd import DeviceType
    got, names = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        names.append(e.key)
        route = flash_route_of(e.key)
        if route:
            got.setdefault(route[0], set()).add(route[1])
    return got, names


def hold_routes(what, label, got, names, want):
    """Print the cores `traced_flash_routes` found for each launch and
    fail unless each launch ran on exactly the core `want` names (the
    traced kernels' names are printed on a miss)."""
    print(f"{what} {label}: " + " ".join(
        f"{p}={'+'.join(sorted(got.get(p, ()))) or 'none'}" for p in want)
        + f" (want {want})", flush=True)
    ok = got == {p: {c} for p, c in want.items()}
    if not ok:
        print(f"{what} {label}: device kernels traced: {names}", flush=True)
    check(ok, f"{what} {label}: the launches ran on {got}, not {want}")


def expected_seg_routes(B, Sq, Sk, Hq, Hk, D, causal, dtype):
    """The core each launch of the segment route takes for q [B, Sq, Hq,
    D] and k/v [B, Sk, Hk, D], ids or none: the forward
    (`flash_attention_seg_fwd`) and the backward
    (`flash_attention_seg_dkv`, `_dq`) on the wgmma core in bf16 and on
    its 3xTF32 form in f32, never an mma.sync or SIMT kernel; the delta
    pre-pass (`flash_attention_delta`) a SIMT kernel in both. Raises
    ValueError for a shape the entries do not take."""
    if not (B > 0 and Sq > 0 and Sk > 0 and Hk > 0 and Hq % Hk == 0
            and D in (64, 128) and not (causal and Sq != Sk)):
        raise ValueError(f"the segment route takes no [B{B} Sq{Sq} Sk{Sk} "
                         f"H{Hq}/{Hk} D{D} {'causal' if causal else 'full'}]")
    core = "wgmma" if str(dtype).split(".")[-1] == "bfloat16" \
        else "wgmma-tf32"
    return {"forward": core, "dkv": core, "dq": core, "delta": "simt"}


def expected_bias_routes(dtype):
    """The core each launch of the bias route takes
    (`flash_attention_bias_fwd`, `_dkv`, `_dq`; its D = rowsum(dO * O) is
    plain PyTorch, no pre-pass kernel): the mma.sync kernels in bf16, the
    SIMT kernels in f32, both in csrc/flash_attention.cu."""
    core = "mma.sync" if str(dtype).split(".")[-1] == "bfloat16" else "simt"
    return {"forward": core, "dkv": core, "dq": core}


def seg_route_check(tag, dtype):
    """Trace one flash_attention_seg_fwd, the delta pre-pass, seg_dkv and
    seg_dq at `testing.ATTN_SEG_CASES[tag]` in `dtype` (the launches of
    the route's autograd function) and hold the cores their device
    kernels name against `expected_seg_routes`."""
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa
    kw = testing.ATTN_SEG_CASES[tag]
    q, k, v, do, sq, skv = testing.attn_seg_case(**kw, dtype=dtype, seed=5)
    causal = kw["causal"]
    s = 1.0 if q.shape[2] != k.shape[2] else q.shape[-1] ** -0.5

    def run():
        o, lse = kfa.flash_attention_seg_fwd(q, k, v, sq, skv, causal, s)
        args = (q, k, v, do, lse, kfa.flash_attention_delta(o, do), sq,
                skv, causal, s)
        kfa.flash_attention_seg_dkv(*args)
        kfa.flash_attention_seg_dq(*args)

    B, Sq, hq, d = q.shape
    Sk, hk = k.shape[1], k.shape[2]
    want = expected_seg_routes(B, Sq, Sk, hq, hk, d, causal, dtype)
    got, names = traced_flash_routes(run, want)
    hold_routes("segment route", f"[{tag} {str(dtype).split('.')[-1]}]",
                got, names, want)
    del q, k, v, do


def bias_route_check(dtype):
    """Trace one bias forward, dkv and dq (`testing.BIAS_CASES`'
    "sdpa_float" case, the surface's sdpa float mask, in `dtype`) and
    hold the cores their device kernels name against
    `expected_bias_routes`."""
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa
    c = testing.bias_case(**testing.BIAS_CASES["sdpa_float"], dtype=dtype)
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    a = kfa._bias_args(c["kind"], c["param"], c["R"], c["padding_mask"],
                       q.shape, k.shape)
    causal, scale = c["causal"], c["scale"]

    def run():
        o, lse = kfa.flash_attention_bias_fwd(q, k, v, a, causal, scale)
        args = (q, k, v, do, lse, kfa._delta(o, do), a, causal, scale)
        kfa.flash_attention_bias_dkv(*args)
        kfa.flash_attention_bias_dq(*args)

    want = expected_bias_routes(dtype)
    got, names = traced_flash_routes(run, want)
    hold_routes("bias route", f"[sdpa_float {str(dtype).split('.')[-1]}]",
                got, names, want)
    del q, k, v, do, a


def flash_route_check(B, S, Hq, Hk, D, causal, dtype=None):
    """Trace one flash_attention_fwd and one flash_attention_bwd (bf16
    unless `dtype` says otherwise) and hold the cores their device
    kernels name against `expected_flash_routes`: no flash_*_mma_kernel
    nor flash_*_simt_kernel may run."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as kfa
    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, do, k, v = rand(B, S, Hq, D), rand(B, S, Hq, D), rand(B, S, Hk, D), \
        rand(B, S, Hk, D)
    scale = 1.0 if Hq != Hk else D ** -0.5

    def run():
        o, lse = kfa.flash_attention_fwd(q, k, v, causal, scale)
        kfa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale)

    want = expected_flash_routes(B, S, Hq, Hk, D, causal, dtype)
    got, names = traced_flash_routes(run, want)
    hold_routes("flash route",
                f"[B{B} S{S} H{Hq}/{Hk} D{D} {'causal' if causal else 'full'}"
                f" {str(dtype).split('.')[-1]}]", got, names, want)
    del q, do, k, v


# the training slices' kernel shapes, batch 4 x seq 2048 = 8192 rows:
# (report path, hidden, intermediate, heads of 128); llama_1b's are the
# kernel table's main entries, llama_7b's go under "training_7b"
TRAIN_KERNEL_SHAPES = (("training", 2048, 5504, 16),
                       ("training_7b", 4096, 11008, 32))


def record(report, name, path, measured):
    """A kernel's bf16 measurements: the first training path's are its
    entry in the kernels line, a later path's sit under that path."""
    if path == TRAIN_KERNEL_SHAPES[0][0]:
        report[name] = entry(name, measured)
    else:
        report[name][path] = measured


def training_kernels(report, dtype, gen):
    """The training slices' kernels at `TRAIN_KERNEL_SHAPES`: fused_add_
    rms_norm, the two SwiGLU backward launches, flash attention forward
    and backward (causal MHA), each held element by element and timed in
    bf16; then one GQA and one head-dim-64 flash case at a small size,
    checked only; then the cross-entropy kernels."""
    import torch

    dname = str(dtype).split(".")[1]

    def rand(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen,
                                  device="cuda")).to(dtype)

    for path, H, M, nh in TRAIN_KERNEL_SHAPES:
        train_kernels_at(report, dtype, gen, rand, path, 8192, H, M, nh)
    for B, S, hq, hk, d, causal in FLASH_SMALL_CASES:
        q, do = rand(B, S, hq, d), rand(B, S, hq, d)
        k, v = rand(B, S, hk, d), rand(B, S, hk, d)
        flash_pairs_checked(dtype, dname, q, k, v, do, causal)
        del q, k, v, do
    torch.cuda.empty_cache()
    for case in FLASH_ROUTE_CASES:
        flash_route_check(*case, dtype=dtype)
    ce_kernels(report, dtype)


def flash_pairs_checked(dtype, dname, q, k, v, do, causal):
    """The flash kernels held against their plain version on q, k, v, do
    BSHD, the delta pre-pass on the kernel's o. Returns (fwd max error,
    bwd max error, delta max error, the kernel's o, lse)."""
    from paddle_tpu_torch import testing
    B, S, hq, d = q.shape
    hk = k.shape[2]
    scale = 1.0 / d ** 0.5
    # GQA keeps the one low-precision step of its float order on both
    # sides: q pre-scaled in q's dtype, the kernel at scale 1
    qs, s = ((q * scale).to(dtype), 1.0) if hq != hk else (q, scale)
    pairs, (o, lse) = testing.flash_pairs(qs, k, v, do, causal, s)
    tag = f" [B{B} S{S} H{hq}/{hk} D{d} {'causal' if causal else 'full'}]"
    err_f = compare("flash_attention_fwd", dname, pairs[:2], tag)
    err_b = compare("flash_attention_bwd", dname, pairs[2:], tag)
    err_d = compare("flash_attention_delta", dname,
                    [testing.delta_pair(o, do)], tag)
    return err_f, err_b, err_d, o, lse


def train_kernels_at(report, dtype, gen, rand, path, T, H, M, nh):
    """One training shape: rows T, hidden H, intermediate M, nh heads of
    128 over a sequence of 2048; rand(*shape, std=1) draws from gen in
    dtype."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import fused_norm_residual as kfnr
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    bf16 = dtype == torch.bfloat16
    dname = str(dtype).split(".")[1]
    it = torch.finfo(dtype).bits // 8
    eps = 1e-5

    # fused_add_rms_norm: x, residual [T, H]
    x, r = rand(T, H), rand(T, H)
    w = 1 + 0.1 * torch.randn((H,), generator=gen, device="cuda")
    y, h = kfnr.fused_add_rms_norm(x, r, w, eps, use_kernel=True)
    # the plain version keeps the one low-precision step of its float
    # order: the norm reads h rounded to the stream dtype
    h_p = x.float() + r.float()
    y_p = krn._plain(h_p.to(dtype).float(), w, eps)
    tag = f" [{T}x{H}]"
    err = compare("fused_add_rms_norm", dname, [("y", y, y_p), ("h", h, h_p)],
                  tag)
    if bf16:
        record(report, "fused_add_rms_norm", path, timed(
            "fused_add_rms_norm", err,
            lambda: kfnr.fused_add_rms_norm(x, r, w, eps, use_kernel=True),
            lambda: kfnr._plain(x, r, w, eps),
            nbytes=4 * x.numel() * it + w.numel() * 4, flops=5 * x.numel(),
            tag=tag))
    del x, r, y, h, y_p, h_p

    # SwiGLU backward: a [T, H], w_gate_up [H, 2M], do [T, M]; bwd_da
    # also recomputes g/u (2 GEMMs of flops), bwd_dw reads the recomputed
    # dgu (1 GEMM)
    a, wgu, do = rand(T, H), rand(H, 2 * M, std=0.02), rand(T, M)
    pairs, dgu = testing.swiglu_bwd_pairs(a, wgu, do)
    tag = f" [{T}x{H} @ {H}x{2 * M}]"
    err_da = compare("swiglu_bwd_da", dname, pairs[:1], tag)
    err_dw = compare("swiglu_bwd_dw", dname, pairs[1:], tag)
    del pairs
    if bf16:
        gemm = 2 * T * H * 2 * M

        def plain_grad(i):
            a_ = a.detach().requires_grad_(i == 0)
            w_ = wgu.detach().requires_grad_(i == 1)
            return torch.autograd.grad(ksw._ref(a_, w_), (a_, w_)[i], do)

        # library: the one product [dg | du] [Wg | Wu]^T, given the dgu
        # the kernel made
        measured = timed(
            "swiglu_bwd_da", err_da, lambda: ksw.swiglu_bwd_da(a, wgu, do),
            lambda: plain_grad(0),
            # a, w_gate_up, do in; da and the [T, 2M] dgu out
            nbytes=(a.numel() + wgu.numel() + do.numel() + a.numel()
                    + dgu.numel()) * it,
            flops=2 * gemm, library=lambda: torch.matmul(dgu, wgu.t()),
            iters=10, tag=tag)

        def library_whole():
            """What the launch does, in PyTorch calls: the g/u product,
            the plain dgu expression, the da product."""
            gu = torch.matmul(a, wgu).float()
            g, u = gu[:, :M], gu[:, M:]
            s = torch.sigmoid(g)
            d = do.float()
            dgu_l = torch.cat((d * u * (s + g * s * (1 - s)), d * (g * s)),
                              1).to(dtype)
            return torch.matmul(dgu_l, wgu.t())

        measured["library_whole_ms"] = time_ms(library_whole, 10)
        print(f"kernel swiglu_bwd_da bf16{tag}: library_whole_ms="
              f"{measured['library_whole_ms']:.6g} (a @ w_gate_up, the "
              f"plain dgu expression, dgu @ w_gate_up^T)", flush=True)
        record(report, "swiglu_bwd_da", path, measured)
        # library: the one product a^T dgu, given the dgu bwd_da made
        record(report, "swiglu_bwd_dw", path, timed(
            "swiglu_bwd_dw", err_dw, lambda: ksw.swiglu_bwd_dw(a, dgu),
            lambda: plain_grad(1),
            nbytes=(a.numel() + dgu.numel() + wgu.numel()) * it,
            flops=gemm, library=lambda: torch.matmul(a.t(), dgu),
            iters=10, tag=tag))
    del a, wgu, do, dgu

    # flash attention: q/k/v [4, 2048, nh, 128] causal MHA
    B, S, d, causal = 4, 2048, 128, True
    check(B * S == T, f"{T} rows are not batch {B} x seq {S}")
    q, k, v, do = (rand(B, S, nh, d) for _ in range(4))
    err_f, err_b, err_d, o, lse = flash_pairs_checked(dtype, dname, q, k, v,
                                                      do, causal)
    if bf16:
        scale = 1.0 / d ** 0.5
        tag = f" [B{B} S{S} H{nh} D{d} causal]"
        pairs = S * (S + 1) // 2
        fwd_flops = 4 * B * nh * d * pairs
        qkv_bytes = 3 * q.numel() * it
        lse_bytes = lse.numel() * 4
        qr, kr, vr = (t.transpose(1, 2) for t in (q, k, v))
        record(report, "flash_attention_fwd", path, timed(
            "flash_attention_fwd", err_f,
            lambda: kfa.flash_attention_fwd(q, k, v, causal, scale),
            lambda: kfa._plain(q, k, v, causal, scale),
            nbytes=qkv_bytes + q.numel() * it + lse_bytes,
            flops=fwd_flops,
            library=lambda: F.scaled_dot_product_attention(
                qr, kr, vr, is_causal=causal),
            iters=20, plain_iters=3, tag=tag))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o_pl = kfa._plain(*leaves, causal, scale)
        lib_leaves = [t.detach().requires_grad_() for t in (qr, kr, vr)]
        do_r = do.transpose(1, 2)
        o_lib = F.scaled_dot_product_attention(*lib_leaves, is_causal=causal)

        def library_fwd_bwd():
            o_l = F.scaled_dot_product_attention(*lib_leaves,
                                                 is_causal=causal)
            return torch.autograd.grad(o_l, lib_leaves, do_r)

        # library: SDPA's backward alone, over a retained forward
        measured = timed(
            "flash_attention_bwd", err_b,
            lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, causal,
                                            scale),
            lambda: torch.autograd.grad(o_pl, leaves, do, retain_graph=True),
            # q, k, v, o, do in; dq, dk, dv out; lse
            nbytes=qkv_bytes + 2 * q.numel() * it + qkv_bytes + lse_bytes,
            # the recomputed scores, dP, dV, dK, dQ: 2.5x forward
            flops=fwd_flops * 5 // 2,
            library=lambda: torch.autograd.grad(o_lib, lib_leaves, do_r,
                                                retain_graph=True),
            iters=10, plain_iters=3, tag=tag)
        measured["library_fwd_bwd_ms"] = time_ms(library_fwd_bwd, 10)
        print(f"kernel flash_attention_bwd bf16{tag}: library_fwd_bwd_ms="
              f"{measured['library_fwd_bwd_ms']:.6g} (SDPA forward and "
              f"backward)", flush=True)
        record(report, "flash_attention_bwd", path, measured)
        # the backward's pre-pass alone: o and do read once, D written
        record(report, "flash_attention_delta", path, timed(
            "flash_attention_delta", err_d,
            lambda: kfa.flash_attention_delta(o, do),
            lambda: kfa._delta(o, do),
            nbytes=2 * q.numel() * it + lse_bytes, flops=2 * q.numel(),
            iters=20, tag=tag, ops_dtype="float32"))
        del leaves, o_pl, lib_leaves, o_lib
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def ce_kernels(report, dtype):
    """The fused cross-entropy kernels at `testing.FUSED_CE_CASES`: the 7B
    training slice's logits [4 x 2047, 32000] (timed in bf16) and a
    1024-row V = 30522 case whose rows take the scalar head and tail,
    with ignore_index rows, a label past the vocabulary and a negative
    one."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import cross_entropy as kce

    dname = str(dtype).split(".")[1]
    it = torch.finfo(dtype).bits // 8
    for tag, kw in testing.FUSED_CE_CASES.items():
        x, lbl, g = testing.fused_ce_case(dtype=dtype, **kw)
        pairs, (m, l) = testing.fused_ce_pairs(x, lbl, g)
        shape = f" [{tag} {x.shape[0]}x{x.shape[1]}]"
        err_f = compare("fused_cross_entropy", dname, pairs[:3], shape)
        err_b = compare("fused_cross_entropy_bwd", dname, pairs[3:], shape)
        del pairs
        if dtype == torch.bfloat16 and tag == "train":
            N, V = x.shape
            row_bytes = lbl.numel() * lbl.element_size()
            leaf = x.detach().requires_grad_()
            # F.cross_entropy asserts on a label outside [0, V) that is
            # not ignore_index: its two such rows take label 0
            lbl_lib = torch.where(((lbl >= 0) & (lbl < V)) | (lbl == -100),
                                  lbl, 0)

            def library_fwd_bwd():
                loss = F.cross_entropy(leaf, lbl_lib, ignore_index=-100,
                                       reduction="none")
                return torch.autograd.grad(loss, leaf, g)

            # forward: the logits and labels read, loss, m and l written;
            # per element a max, a subtraction, an exponential and a sum
            report["fused_cross_entropy"] = entry(
                "fused_cross_entropy", timed(
                    "fused_cross_entropy", err_f,
                    lambda: kce.fused_cross_entropy_fwd(x, lbl),
                    lambda: kce._plain_fwd(x, lbl, -100),
                    nbytes=x.numel() * it + row_bytes + 3 * N * 4,
                    flops=4 * N * V, ops_dtype="float32",
                    library=lambda: F.cross_entropy(
                        x, lbl_lib, ignore_index=-100, reduction="none"),
                    iters=20, plain_iters=5))
            # backward: the logits, labels, m, l and g read, dx written;
            # per element a subtraction, an exponential, two products and
            # the one-hot subtraction. library: F.cross_entropy forward
            # and backward under autograd
            report["fused_cross_entropy_bwd"] = entry(
                "fused_cross_entropy_bwd", timed(
                    "fused_cross_entropy_bwd", err_b,
                    lambda: kce.fused_cross_entropy_bwd(x, lbl, m, l, g),
                    lambda: kce._plain_bwd(x, lbl, m, l, g, -100),
                    nbytes=2 * x.numel() * it + row_bytes + 3 * N * 4,
                    flops=5 * N * V, ops_dtype="float32",
                    library=library_fwd_bwd, iters=20, plain_iters=5))
            del leaf, lbl_lib
        del x, lbl, g, m, l
        torch.cuda.empty_cache()


def _seg_pairs(seg_q, seg_kv, causal):
    """The (q, key) pairs the segment ids (and the causal mask) leave:
    the work the segment kernels' function needs, per head."""
    import torch
    n = 0
    for b in range(seg_q.shape[0]):
        for s in torch.unique(seg_q[b]).tolist():
            nq = int((seg_q[b] == s).sum())
            nk = int((seg_kv[b] == s).sum())
            n += nq * (nq + 1) // 2 if causal else nq * nk
    return n


def attention_kernels(report, dtype):
    """The masked and packed attention kernels at the BERT and
    attention-surface phases' shapes: the three segment-id flash kernels
    at `testing.ATTN_SEG_CASES` (BERT's padded [16, 512, 12, 64], the
    packed causal [8192, 32, 128] of the 7B-width case, small GQA,
    cross-length and packed MQA cases), and the block-stats kernel at
    `testing.STATS_CASES` (sdpa's bias route at bert width, a 512-key
    alibi chunk at 7B width, a masked ragged case, the diagonal round of
    ring attention at 7B width), element by element. Timed: the segment
    kernels at "bert" (bf16: the entry; f32: the BERT phase's dtype,
    "bert_f32") and "packed_7b" (bf16); the block-stats kernel at
    `STATS_TIMED` (bf16 "sdpa_bias" the entry, "alibi_7b", "ring_7b";
    f32 "sdpa_bias_f32"), each with its traced device time and host
    enqueue time (`stats_timed`); in f32 the
    one-length flash kernels at ERNIE's shape (`ernie_flash_f32`). One
    forward, delta pre-pass, dkv and dq at every bf16 case, and at
    "bert" in f32, is traced to its cores (`seg_route_check`)."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import block_attention as kba

    dname = str(dtype).split(".")[1]
    bf16 = dtype == torch.bfloat16
    it = torch.finfo(dtype).bits // 8
    for tag, kw in testing.ATTN_SEG_CASES.items():
        q, k, v, do, sq, skv = testing.attn_seg_case(**kw, dtype=dtype)
        causal = kw["causal"]
        B, S, hq, d = q.shape
        Sk, hk = k.shape[1], k.shape[2]
        scale = d ** -0.5
        # GQA keeps the one low-precision step of its float order on both
        # sides: q pre-scaled in q's dtype, the kernels at scale 1
        qs, s = ((q * scale).to(dtype), 1.0) if hq != hk else (q, scale)
        shape = (f" [{tag} B{B} S{S}/{Sk} H{hq}/{hk} D{d} "
                 f"{'causal' if causal else 'full'}]")
        # the packed 7B case's f32 [8192, 8192] scores take 8.6 GB a
        # buffer at 32 heads: its plain side runs 8 heads at a time
        pairs, _ = testing.seg_flash_pairs(
            qs, k, v, do, sq, skv, causal, s,
            heads=8 if tag == "packed_7b" else None)
        errs = {"fwd": compare("flash_attention_seg_fwd", dname, pairs[:2],
                               shape),
                "dkv": compare("flash_attention_seg_dkv", dname, pairs[3:],
                               shape),
                "dq": compare("flash_attention_seg_dq", dname, pairs[2:3],
                              shape)}
        del pairs
        timed_here = (tag == "bert" or (bf16 and tag == "packed_7b"))
        if timed_here:
            seg_timings(report, tag, dtype, errs, qs, k, v, do, sq, skv,
                        causal, s, shape)
        del q, k, v, do, qs, sq, skv
        torch.cuda.empty_cache()
        # every bf16 case's launches, and f32 at BERT's shape, traced to
        # their cores
        if bf16 or tag == "bert":
            seg_route_check(tag, dtype)
            torch.cuda.empty_cache()
    if not bf16:
        ernie_flash_f32(report)

    for tag, kw in testing.STATS_CASES.items():
        q, k, v, mask, scale, bias = testing.stats_case(**kw, dtype=dtype)
        shape = f" [{tag} q{tuple(q.shape)} k{tuple(k.shape)}]"
        err = compare("block_attention_stats", dname,
                      testing.block_stats_pairs(q, k, v, mask, scale, bias),
                      shape)
        if tag in STATS_TIMED[bf16]:
            m = stats_timed(kba, err, q, k, v, mask, scale, bias, shape)
            if bf16 and tag == "sdpa_bias":
                report["block_attention_stats"] = entry(
                    "block_attention_stats", m)
            else:
                report["block_attention_stats"][
                    tag if bf16 else f"{tag}_f32"] = m
        del q, k, v, mask, bias
        torch.cuda.empty_cache()
    bias_kernels(report, dtype)


# row 8's timed cases (`testing.STATS_CASES`), by dtype: bf16 on the
# wgmma core, f32 on the SIMT kernel
STATS_TIMED = {True: ("sdpa_bias", "alibi_7b", "ring_7b"),
               False: ("sdpa_bias",)}


def stats_work(q, k, mask, bias):
    """The bytes and operations of one block-stats call: q, k, v, the mask
    and the bias as the route passes them (compact, read in place) in, m,
    l and o f32 out; Q K^T and P V over the entries the mask and the bias
    leave valid (the causal ring round: its lower triangle)."""
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    it = q.element_size()
    valid = None
    if bias is not None:
        valid = (bias > -5e29).expand(B, H, Sq, Sk)
    if mask is not None:
        mk = mask.bool().expand(Sq, Sk)
        valid = mk.expand(B, H, Sq, Sk) if valid is None else valid & mk
    pairs = B * H * Sq * Sk if valid is None else int(valid.sum())
    nbytes = ((q.numel() + 2 * k.numel()) * it
              + (0 if bias is None else bias.numel() * 4)
              + (0 if mask is None else mask.numel())
              + 2 * B * H * Sq * 4 + q.numel() * 4)
    return nbytes, 4 * pairs * d


def stats_timed(kba, err, q, k, v, mask, scale, bias, shape):
    """Row 8 at one case: events beside the plain version (`_dense_stats`)
    and the bound (bf16 at the tensor-core rate; f32, which runs SIMT, at
    the f32 rate), the card's own time and the host's time to enqueue a
    call (`split_times`); no library call returns the unnormalised
    (m, l, o)."""
    bf16 = q.element_size() == 2
    nbytes, flops = stats_work(q, k, mask, bias)

    def call():
        return kba.block_attention_fwd(q, k, v, mask, scale, bias)

    m = timed("block_attention_stats", err, call,
              lambda: kba._dense_stats(q, k, v, mask, scale, bias),
              nbytes=nbytes, flops=flops, iters=20, plain_iters=3, tag=shape,
              ops_dtype="bfloat16" if bf16 else "float32",
              dname="bf16" if bf16 else "f32")
    m.update(split_times(call, STATS_KERNEL, m["bound_ms"],
                         f"block_attention_stats{shape}"))
    return m


def bias_kernels(report, dtype):
    """The bias kernels (forward, dkv, dq) at `testing.BIAS_CASES`
    against their plain versions (`_biased_plain_fwd`,
    `_biased_plain_bwd`) under the flash rule, element by element; in
    bf16 each case but "alibi_gqa" is timed beside the plain versions,
    SDPA with the same f32 bias as attn_mask and the bound over the
    entries the bias leaves ("alibi_7b" is each kernel's entry)."""
    import torch

    from paddle_tpu_torch import testing

    dname = str(dtype).split(".")[1]
    for tag, kw in testing.BIAS_CASES.items():
        c = testing.bias_case(**kw, dtype=dtype)
        B, Sq, hq, d = c["q"].shape
        Sk, hk = c["k"].shape[1:3]
        shape = (f" [{tag} B{B} Sq{Sq}/{Sk} H{hq}/{hk} D{d} {c['kind']} "
                 f"{'causal' if c['causal'] else 'full'}]")
        pairs, _ = testing.bias_flash_pairs(
            c["q"], c["k"], c["v"], c["do"], c["kind"], c["param"], c["R"],
            c["padding_mask"], c["causal"], c["scale"])
        errs = {"fwd": compare("flash_attention_bias_fwd", dname, pairs[:2],
                               shape),
                "dkv": compare("flash_attention_bias_dkv", dname, pairs[3:],
                               shape),
                "dq": compare("flash_attention_bias_dq", dname, pairs[2:3],
                              shape)}
        del pairs
        if dtype == torch.bfloat16 and tag != "alibi_gqa":
            bias_timings(report, tag, c, errs, shape)
        del c
        torch.cuda.empty_cache()
    bias_route_check(dtype)


def _bias_pairs(c):
    """The (q, key) entries the bias and its masks leave valid, summed
    over batch and heads: the work the bias kernels' function needs."""
    from paddle_tpu_torch.kernels import flash_attention as kfa
    B, Sq, hq, _ = c["q"].shape
    Sk = c["k"].shape[1]
    params = c["param"] if c["R"] is None else (c["param"], c["R"])
    n = 0
    for s0, s1 in kfa._chunks(Sk, None):
        bias = kfa._bias_chunk(c["kind"], params, Sq, s0, s1, c["causal"],
                               c["padding_mask"])
        n += int((bias > -5e29).expand(B, hq, Sq, s1 - s0).sum())
    return n


def bias_timings(report, tag, c, errs, shape):
    """The bias kernels' times at one bf16 case: forward, dkv and dq
    beside the plain versions, SDPA with the route's f32 bias (the causal
    and padding masks folded in) as attn_mask (fwd; fwd + bwd for dkv and
    dq) and the bounds over the entries the bias leaves."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as kfa
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    kind, param, R, pm = c["kind"], c["param"], c["R"], c["padding_mask"]
    causal, scale = c["causal"], c["scale"]
    B, Sq, hq, d = q.shape
    Sk, hk = k.shape[1:3]
    it = 2
    pairs = _bias_pairs(c)
    a = kfa._bias_args(kind, param, R, pm, q.shape, k.shape)
    # the bias as the route passes it: the compact f32 parameter and the
    # uint8 padding mask
    bias_bytes = param.numel() * 4 + (0 if pm is None else B * Sk)
    lse_bytes = 4 * B * hq * Sq
    qkv = (q.numel() + k.numel() + v.numel()) * it
    plain = (kind, param, R, causal, scale, pm, None)
    o, lse = kfa.flash_attention_bias_fwd(q, k, v, a, causal, scale)
    delta = kfa._delta(o, do)
    args = (q, k, v, do, lse, delta, a, causal, scale)
    full = kfa._bias_chunk(kind, param if R is None else (param, R), Sq, 0,
                           Sk, causal, pm)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = hq != hk
    lib_leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    do_t = do.transpose(1, 2)

    def library_fwd_bwd():
        o_l = F.scaled_dot_product_attention(*lib_leaves, attn_mask=full,
                                             enable_gqa=gqa)
        return torch.autograd.grad(o_l, lib_leaves, do_t)

    def put(name, m):
        if tag == "alibi_7b":
            report[name] = entry(name, m)
        else:
            report[name][tag] = m

    put("flash_attention_bias_fwd", timed(
        "flash_attention_bias_fwd", errs["fwd"],
        lambda: kfa.flash_attention_bias_fwd(q, k, v, a, causal, scale),
        lambda: kfa._biased_plain_fwd(q, k, v, *plain),
        nbytes=qkv + q.numel() * it + lse_bytes + bias_bytes,
        flops=4 * pairs * d,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=full, enable_gqa=gqa),
        iters=10, plain_iters=2, tag=shape))
    for name, fn, flops, out_bytes in (
            ("flash_attention_bias_dkv",
             lambda: kfa.flash_attention_bias_dkv(*args), 8 * pairs * d,
             (k.numel() + v.numel()) * it),
            ("flash_attention_bias_dq",
             lambda: kfa.flash_attention_bias_dq(*args), 6 * pairs * d,
             q.numel() * it)):
        # q, k, v, do, lse, D and the bias in; dk and dv, or dq, out.
        # flops: dkv recomputes S and dP and forms dV and dK (4
        # products), dq recomputes S and dP and forms dQ (3)
        put(name, timed(
            name, errs["dkv" if name.endswith("dkv") else "dq"], fn,
            lambda: kfa._biased_plain_bwd(q, k, v, o, lse, do, *plain),
            nbytes=qkv + do.numel() * it + 2 * lse_bytes + bias_bytes
            + out_bytes, flops=flops, library=library_fwd_bwd, iters=5,
            plain_iters=2, tag=shape))
    del lib_leaves, full, o, lse, delta, a


def seg_timings(report, tag, dtype, errs, q, k, v, do, sq, skv, causal, s,
                shape):
    """The segment kernels' times at one case: the forward, dkv and dq
    kernels beside the plain version (`_SegPlain`, the packed case in
    groups of 8 heads), SDPA with the segment-equality boolean mask (the
    forward; for dkv and dq its backward alone over a retained forward,
    with its forward and backward beside it as `library_fwd_bwd_ms`; for
    dkv and dq both also as the card's own time, `device_ms` and
    `library_device_ms`, by `traced_device_ms`) and the bounds over the
    pairs the segments leave. bf16 "bert" is each
    kernel's entry; f32 "bert" (the BERT phase's dtype) goes under
    "bert_f32": its forward, dkv and dq run in 3xTF32 and are bound by
    `timed_3xtf32` (three tf32 products a product at the tf32 rate;
    `bound_simt_ms` beside), and its forward carries both sides' traced
    device time too."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as kfa
    bf16 = dtype == torch.bfloat16
    dn = "bf16" if bf16 else "f32"
    it = torch.finfo(dtype).bits // 8
    B, S, hq, d = q.shape
    Sk = k.shape[1]
    pairs = _seg_pairs(sq, skv, causal) * hq
    seg_bytes = 4 * (sq.numel() + skv.numel())
    lse_bytes = 4 * B * hq * S
    qkv = (q.numel() + k.numel() + v.numel()) * it
    heads = 8 if tag == "packed_7b" else hq

    def plain_fwd():
        for h0 in range(0, hq, heads):
            h = slice(h0, h0 + heads)
            kfa._SegPlain.apply(q[:, :, h], k[:, :, h], v[:, :, h], sq, skv,
                                causal, s)

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    allow = sq[:, None, :, None] == skv[:, None, None, :]
    if causal:
        allow = allow & torch.ones((S, Sk), dtype=torch.bool,
                                   device="cuda").tril()
    o, lse = kfa.flash_attention_seg_fwd(q, k, v, sq, skv, causal, s)
    key = "bert" if bf16 and tag == "bert" else (
        "bert_f32" if tag == "bert" else tag)

    def timed_at(*args, **kw):
        if bf16:
            return timed(*args, ops_dtype="bfloat16", dname="bf16", **kw)
        return timed_3xtf32(*args, **kw)

    def put(name, m):
        if key == "bert":
            report[name] = entry(name, m)
        else:
            report[name][key] = m

    fwd_bytes = qkv + q.numel() * it + lse_bytes + seg_bytes
    put("flash_attention_seg_fwd", timed_at(
        "flash_attention_seg_fwd", errs["fwd"],
        lambda: kfa.flash_attention_seg_fwd(q, k, v, sq, skv, causal, s),
        plain_fwd, nbytes=fwd_bytes, flops=4 * pairs * d,
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=allow),
        iters=20, plain_iters=3, tag=shape))
    core = "wgmma" if bf16 else "tf32"       # the kernels' name fragment
    if not bf16:
        m = report["flash_attention_seg_fwd"][key]
        m["device_ms"] = traced_device_ms(
            lambda: kfa.flash_attention_seg_fwd(q, k, v, sq, skv, causal, s),
            kernel=f"flash_fwd_{core}_kernel")
        m["library_device_ms"] = traced_device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=allow))
        print(f"kernel flash_attention_seg_fwd f32{shape}: the f32 rate's "
              f"bound_simt_ms={m['bound_simt_ms']:.6g}; device "
              f"(traced) kernel {m['device_ms']:.6g} library "
              f"{m['library_device_ms']:.6g}", flush=True)
    delta = kfa.flash_attention_delta(o, do)
    args = (q, k, v, do, lse, delta, sq, skv, causal, s)
    lib_leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    do_t = do.transpose(1, 2)
    o_lib = F.scaled_dot_product_attention(*lib_leaves, attn_mask=allow)

    def library_fwd_bwd():
        o_l = F.scaled_dot_product_attention(*lib_leaves, attn_mask=allow)
        return torch.autograd.grad(o_l, lib_leaves, do_t)

    def plain_bwd():
        for h0 in range(0, hq, heads):
            h = slice(h0, h0 + heads)
            leaves = [t[:, :, h].detach().requires_grad_()
                      for t in (q, k, v)]
            o_p = kfa._SegPlain.apply(*leaves, sq, skv, causal, s)
            torch.autograd.grad(o_p, leaves, do[:, :, h])

    lib_fb_ms = time_ms(library_fwd_bwd, 10)
    for name, fn, flops, out_bytes in (
            ("flash_attention_seg_dkv",
             lambda: kfa.flash_attention_seg_dkv(*args), 8 * pairs * d,
             (k.numel() + v.numel()) * it),
            ("flash_attention_seg_dq",
             lambda: kfa.flash_attention_seg_dq(*args), 6 * pairs * d,
             q.numel() * it)):
        # q, k, v, do, lse, D and the segments in; dk and dv, or dq, out.
        # flops: dkv recomputes S and dP and forms dV and dK (4
        # products), dq recomputes S and dP and forms dQ (3). library:
        # SDPA's backward alone over a retained forward (the whole
        # backward, for each of the two launches)
        nbytes = (qkv + do.numel() * it + 2 * lse_bytes + seg_bytes
                  + out_bytes)

        def library():
            return torch.autograd.grad(o_lib, lib_leaves, do_t,
                                       retain_graph=True)

        m = timed_at(
            name, errs["dkv" if name.endswith("dkv") else "dq"], fn,
            plain_bwd, nbytes=nbytes, flops=flops, library=library,
            iters=10, plain_iters=2, tag=shape)
        m["library_fwd_bwd_ms"] = lib_fb_ms
        # the card's own time of the launch (its trace held to one launch
        # a call) and of SDPA's backward alone
        m["device_ms"] = traced_device_ms(
            fn, kernel=f"flash_bwd_{name.rsplit('_', 1)[1]}_{core}_kernel")
        m["library_device_ms"] = traced_device_ms(library)
        extra = ("" if bf16 else
                 f"; the f32 rate's bound_simt_ms={m['bound_simt_ms']:.6g}")
        print(f"kernel {name} {dn}{shape}: library_fwd_bwd_ms="
              f"{lib_fb_ms:.6g} (SDPA forward and backward); device "
              f"(traced) kernel {m['device_ms']:.6g} library "
              f"{m['library_device_ms']:.6g}{extra}", flush=True)
        put(name, m)
    del lib_leaves, o_lib, allow, o, lse, delta


def ernie_flash_f32(report):
    """The f32 one-length flash kernels (3xTF32, csrc/flash_wgmma.cu) at
    ERNIE's attention shape, bench.py:399-421's encoder configuration
    without a mask: [16, 512, 12, 64], full. Held against the plain
    version, traced to their cores (`flash_route_check`: no SIMT kernel
    may run) and timed beside SDPA in f32 (TF32 off), each side also by
    its traced device time (`device_ms`, `library_device_ms`), with
    `timed_3xtf32`'s bounds (bound_ms: three tf32 products a product at
    the tf32 rate; `bound_simt_ms`: the f32 rate), under "ernie_f32" in
    the flash_attention_fwd and flash_attention_bwd entries."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as kfa
    dt = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(17)
    B, S, H, d, causal = 16, 512, 12, 64, False
    q, k, v, do = (torch.randn((B, S, H, d), generator=gen, device="cuda")
                   for _ in range(4))
    err_f, err_b, _, o, lse = flash_pairs_checked(dt, "float32", q, k, v, do,
                                                  causal)
    flash_route_check(B, S, H, H, d, causal, dtype=dt)
    scale = d ** -0.5
    tag = f" [B{B} S{S} H{H} D{d} full]"
    fwd_flops = 4 * B * H * d * S * S
    qkv_bytes = 3 * q.numel() * 4
    lse_bytes = lse.numel() * 4
    qr, kr, vr = (t.transpose(1, 2) for t in (q, k, v))
    fwd_bytes = qkv_bytes + q.numel() * 4 + lse_bytes
    m = timed_3xtf32(
        "flash_attention_fwd", err_f,
        lambda: kfa.flash_attention_fwd(q, k, v, causal, scale),
        lambda: kfa._plain(q, k, v, causal, scale),
        nbytes=fwd_bytes, flops=fwd_flops,
        library=lambda: F.scaled_dot_product_attention(qr, kr, vr),
        iters=10, plain_iters=3, tag=tag)
    m["device_ms"] = traced_device_ms(
        lambda: kfa.flash_attention_fwd(q, k, v, causal, scale),
        kernel="flash_fwd_tf32_kernel")
    m["library_device_ms"] = traced_device_ms(
        lambda: F.scaled_dot_product_attention(qr, kr, vr))
    report["flash_attention_fwd"]["ernie_f32"] = m
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o_pl = kfa._plain(*leaves, causal, scale)
    lib_leaves = [t.detach().requires_grad_() for t in (qr, kr, vr)]
    do_r = do.transpose(1, 2)
    o_lib = F.scaled_dot_product_attention(*lib_leaves)

    def library_fwd_bwd():
        o_l = F.scaled_dot_product_attention(*lib_leaves)
        return torch.autograd.grad(o_l, lib_leaves, do_r)

    def library():
        return torch.autograd.grad(o_lib, lib_leaves, do_r,
                                   retain_graph=True)

    bwd_bytes = qkv_bytes + 2 * q.numel() * 4 + qkv_bytes + lse_bytes
    m = timed_3xtf32(
        "flash_attention_bwd", err_b,
        lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale),
        lambda: torch.autograd.grad(o_pl, leaves, do, retain_graph=True),
        nbytes=bwd_bytes, flops=fwd_flops * 5 // 2, library=library,
        iters=10, plain_iters=3, tag=tag)
    m["library_fwd_bwd_ms"] = time_ms(library_fwd_bwd, 10)
    # one dkv and one dq launch a call (after the delta pre-pass): the
    # trace holds the dq launches
    m["device_ms"] = traced_device_ms(
        lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, causal, scale),
        kernel="flash_bwd_dq_tf32_kernel")
    m["library_device_ms"] = traced_device_ms(library)
    fwd = report["flash_attention_fwd"]["ernie_f32"]
    print(f"kernel flash_attention f32{tag}: the f32 rate's bound_simt_ms "
          f"fwd={fwd['bound_simt_ms']:.6g} bwd={m['bound_simt_ms']:.6g}; "
          f"device (traced) kernel fwd {fwd['device_ms']:.6g} bwd "
          f"{m['device_ms']:.6g}; SDPA f32 device (traced) fwd "
          f"{fwd['library_device_ms']:.6g} bwd alone "
          f"{m['library_device_ms']:.6g}; bwd library_fwd_bwd_ms="
          f"{m['library_fwd_bwd_ms']:.6g} (SDPA f32 forward and backward)",
          flush=True)
    report["flash_attention_bwd"]["ernie_f32"] = m
    del q, k, v, do, o, lse, leaves, o_pl, lib_leaves, o_lib
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_routes():
    """Swap the kernel wrappers the model calls for their plain
    versions (the comparison route; the port itself never does this):
    the bias route (a float mask) runs `_biased_plain_fwd` /
    `_biased_plain_bwd`, as on the CPU.
    SwiGLU runs on f32 copies and rounds once, as the kernel does; the
    other plain versions already keep f32 inside. All of them are plain
    PyTorch under autograd, so the training backward runs plain too."""
    import torch

    from paddle_tpu_torch.kernels import block_attention as kba
    from paddle_tpu_torch.kernels import cross_entropy as kce
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import fused_norm_residual as kfnr
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    saved = (krn.rms_norm, ksw.swiglu, krpa.ragged_paged_attention,
             kfnr.fused_add_rms_norm, kfa.flash_attention_bshd,
             kpa.paged_decode_attention, kce.fused_cross_entropy,
             kfa._SegFlash, kba.block_attention_fwd,
             kwol.weight_only_linear)
    real_bshd = kfa.flash_attention_bshd
    krn.rms_norm = lambda x, w, eps=1e-6, use_kernel=None: krn._plain(
        x, w, eps)
    # a remat site's kept `out` is not taken: the plain expression is
    # recomputed, saving the same tensors in the forward and the recompute
    ksw.swiglu = lambda a, w, use_kernel=None, out=None: ksw._ref(
        a.float(), w.float()).to(a.dtype)
    kce.fused_cross_entropy = (
        lambda logits, labels, ignore_index=-100, use_kernel=None:
        kce._plain(logits, labels, ignore_index))
    krpa.ragged_paged_attention = (
        lambda q, kp, vp, qs, ql, kl, pt, scale=None, use_kernel=None,
        row_tiles=None: krpa._dense_fallback(q, kp, vp, qs, ql, kl, pt,
                                             scale))
    kfnr.fused_add_rms_norm = (
        lambda x, r, w, eps=1e-6, use_kernel=None: kfnr._plain(x, r, w, eps))
    def plain_bshd(q, k, v, causal=False, scale=None, padding_mask=None,
                   bias=None, use_kernel=None, mask_queries=None):
        # one length, no mask: the dense `_plain`; a bias: its plain
        # versions (`biased_plain`); the segment route runs its own
        # Python with the kernels below swapped
        if bias is not None:
            if padding_mask is not None:
                padding_mask = padding_mask.to(q.device).bool()
            return kfa.biased_plain(q, k, v, "dense", bias.to(q.device),
                                    causal=causal, scale=scale,
                                    padding_mask=padding_mask)
        if padding_mask is None and q.shape[1] == k.shape[1]:
            return kfa._plain(q, k, v, causal, scale)
        return real_bshd(q, k, v, causal, scale, padding_mask, bias,
                         mask_queries=mask_queries)

    class PlainSeg:
        @staticmethod
        def apply(q, k, v, seg_q, seg_kv, causal, scale):
            if seg_q is None:
                return kfa._plain(q, k, v, causal, scale)
            return kfa._SegPlain.apply(q, k, v, seg_q, seg_kv, causal, scale)

    kfa.flash_attention_bshd = plain_bshd
    kfa._SegFlash = PlainSeg
    kba.block_attention_fwd = (
        lambda q, k, v, mask, scale, bias=None:
        kba._dense_stats(q, k, v, mask, scale, bias))
    kpa.paged_decode_attention = (
        lambda q, kp, vp, lens, pidx, scale=None, use_kernel=None:
        kpa._plain(q, kp, vp, lens, pidx,
                   q.shape[-1] ** -0.5 if scale is None else scale))

    def plain_wol(a, q, s, bias=None, swiglu=False, use_kernel=None):
        # the kernel's dequantized weight, an f32 product, one rounding
        w = kwol.dequantize(q, s, a.dtype).float()
        out = ksw._ref(a.float(), w) if swiglu else a.float() @ w
        if bias is not None:
            out = out.to(a.dtype).float() + bias.float()
        return out.to(a.dtype)

    kwol.weight_only_linear = plain_wol
    try:
        yield
    finally:
        (krn.rms_norm, ksw.swiglu, krpa.ragged_paged_attention,
         kfnr.fused_add_rms_norm, kfa.flash_attention_bshd,
         kpa.paged_decode_attention, kce.fused_cross_entropy,
         kfa._SegFlash, kba.block_attention_fwd,
         kwol.weight_only_linear) = saved


def post_stream(port, prompt, max_new, out, idx, deadline_s=300.0,
                extra=None, headers=None):
    """POST one streamed /v1/generate (`extra`: more body fields,
    `headers`: more request headers); record TTFT, tokens, end status,
    the end time and the X-Request-Id response header. Gives up (end
    None) after deadline_s: keepalive frames would keep a stalled stream
    open forever."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/generate",
                 body=json.dumps({"prompt": prompt,
                                  "max_new_tokens": max_new,
                                  **(extra or {})}),
                 headers={"Content-Type": "application/json",
                          **(headers or {})})
    resp = conn.getresponse()
    request_id = resp.getheader("X-Request-Id")
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
    t1 = time.perf_counter()
    out[idx] = {"tokens": toks, "ttft_s": ttft, "end": end,
                "wall_s": t1 - t0, "t_end": t1, "request_id": request_id}


def slice_phase(report, smi_line):
    """Phases 4, 4b and 4c: the ragged serving burst through the default
    engine (speculation armed), through the kill switch, and through the
    speculative engine with an oracle drafter."""
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
    knobs = dict(max_batch=4, max_seq=1024, page_size=16,
                 max_chunk_tokens=64, device="cuda")
    engine = gw.build_engine(model, **knobs)
    check(engine._T_pack == 128, f"packed rows {engine._T_pack} != 128")
    check(engine._spec and engine.max_draft_tokens == 4,
          "the default engine did not arm speculation with 4 drafts")
    K = engine.max_draft_tokens + 1
    verify_lm_head_check(L, engine, cfg, smi_line)

    # capture three mixed prefill + decode steps' inputs and up to two
    # steps with a verify entry (pools before)
    captured = []
    real_fn = engine._ragged_fn

    def capturing_fn():
        step = real_fn()

        def run(state, toks, k_pool, v_pool, page_ids, offs, pos,
                page_table, q_start, q_len, kv_len, produce, verify, g):
            mixed = (bool((q_len > 1).any()) and bool((q_len == 1).any())
                     and int((q_len > 0).sum()) >= 3)
            spec = bool((verify & (q_len > 1)).any())
            n_mixed = sum(not c[2] for c in captured)
            n_spec = sum(c[2] for c in captured)
            if (mixed and n_mixed < 3) or (spec and n_spec < 2):
                captured.append(([t.clone() for t in (
                    toks, pos, page_ids, offs, page_table, q_start, q_len,
                    kv_len)], (k_pool.clone(), v_pool.clone()), spec,
                    verify.clone()))
            return step(state, toks, k_pool, v_pool, page_ids, offs, pos,
                        page_table, q_start, q_len, kv_len, produce, verify,
                        g)

        return run

    engine._ragged_fn = capturing_fn
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, cfg.vocab_size, 48).tolist()
    prompts = [rng.randint(1, cfg.vocab_size, 17).tolist(),
               rng.randint(1, cfg.vocab_size, 100).tolist(),
               prefix + rng.randint(1, cfg.vocab_size, 252).tolist(),
               prefix + rng.randint(1, cfg.vocab_size, 652).tolist()]
    max_new = 32
    kernels = {"rms_norm": krn.rms_norm, "swiglu": ksw.swiglu,
               "ragged_paged_attention": krpa.ragged_paged_attention}
    L_ = cfg.num_hidden_layers

    def burst(eng, what, path=None):
        """One in-order burst; launch counts held per step; returns
        (results, wall, steps, ticks, drafted, accepted)."""
        results, wall, launches, (steps, ticks, drafted, accepted) = \
            serve_burst(eng, prompts, max_new, kernels, what,
                        lambda: (eng.model_steps, eng.ticks,
                                 eng.spec_drafted, eng.spec_accepted),
                        in_order=True)
        want = {"rms_norm": steps * (2 * L_ + 1), "swiglu": steps * L_,
                "ragged_paged_attention": steps * L_}
        for name, n in launches.items():
            print(f"launches {name} ({what}): {n} (steps {steps} -> "
                  f"expected {want[name]})", flush=True)
            check(n == want[name] and n > 0,
                  f"{name} launched {n} times in the {what}, expected "
                  f"{want[name]}")
            if path:
                add_launches(report, name, path, n)
        ttfts = [results[i]["ttft_s"] for i in range(len(prompts))]
        n_tok = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
        rate = accepted / drafted if drafted else 0.0
        print(f"serve ({what}): ticks={ticks} steps={steps} prompts="
              f"{[len(p) for p in prompts]} max_new={max_new} "
              f"drafted={drafted} accepted={accepted} "
              f"acceptance_rate={rate:.6g} preemptions={eng.preemptions} "
              f"[{smi_line}]", flush=True)
        print(f"serve ({what}): ttft_ms={[round(1e3 * t, 3) for t in ttfts]} "
              f"wall_s={wall:.6g} tokens_per_s={n_tok / wall:.6g} "
              f"[{smi_line}]", flush=True)
        return results, wall, steps, ticks, drafted, accepted

    # 4: the default engine, speculation armed
    res_on, wall_on, steps, ticks_on, drafted, _ = burst(
        engine, "request", "serving")
    health = engine.health_snapshot()
    print(f"serve: health speculative={json.dumps(health['speculative'])} "
          f"prefix_cache={health.get('prefix_cache', {}).get('hits')} hits",
          flush=True)
    check(health["speculative"]["armed"], "healthz: speculation not armed")

    # the captured steps through the kernel route and the plain route
    n_mixed = sum(not c[2] for c in captured)
    n_spec = sum(c[2] for c in captured)
    check(n_mixed == 3, f"{n_mixed} of 3 mixed prefill/decode steps with "
          f"3+ live sequences were captured")
    check(n_spec >= 1, f"no step with a verify entry of q_len > 1 was "
          f"captured (drafted {drafted} in the burst)")
    j = torch.arange(K, device="cuda")[None, :]
    for i, (args, (kp0, vp0), spec, verify) in enumerate(captured):
        kw = dict(verify_rows=K, row_tiles=verify, wls=engine._wls)
        with torch.no_grad():
            lg_k, _, _ = L._ragged_step_paged(
                engine.state, cfg, args[0], args[1], kp0.clone(),
                vp0.clone(), *args[2:], **kw)
            torch.cuda.synchronize()
            with plain_routes():
                lg_p, _, _ = L._ragged_step_paged(
                    engine.state, cfg, args[0], args[1], kp0.clone(),
                    vp0.clone(), *args[2:], **kw)
            torch.cuda.synchronize()
        q_len = args[6]
        live = (q_len[:, None] > 0) & (j >= K - torch.clamp(q_len, max=K)
                                       [:, None])
        diff = (lg_k[live] - lg_p[live]).abs()
        err = diff.max().item()
        agree = int((lg_k[live].argmax(-1) == lg_p[live].argmax(-1)).sum())
        mean = diff.mean().item()
        ok = (err <= STEP_ATOL and mean <= STEP_MEAN_ATOL
              and bool(torch.isfinite(lg_k[live]).all()))
        print(f"step {i} ({'verify' if spec else 'mixed'}): q_len="
              f"{q_len.tolist()} verify={verify.int().tolist()} kernel vs "
              f"plain route logits of {int(live.sum())} live rows "
              f"max_abs_err={err:.6g} (limit {STEP_ATOL:g}) "
              f"mean_abs_err={mean:.6g} (limit {STEP_MEAN_ATOL:g}) "
              f"max|logit|={lg_p[live].abs().max().item():.6g} "
              f"argmax agree {agree}/{int(live.sum())} "
              f"{'ok' if ok else 'MISS'}", flush=True)
        check(ok, f"kernel-route step {i} disagrees with the plain route")
    args, (kp0, vp0), _, verify = captured[0]
    # phase 6d reads the int8 step's device time beside this one
    report["_bf16_step_device_ms"] = step_breakdown(
        L, engine, cfg, args, kp0, vp0, wall_on / steps, smi_line,
        verify_rows=K, row_tiles=verify)
    del captured, engine
    import gc
    gc.collect()
    torch.cuda.empty_cache()

    # 4b: the kill switch, token-identical stream by stream
    off = gw.build_engine(model, speculative=False, **knobs)
    check(not off._spec, "speculative=False armed speculation")
    res_off, wall_off, _, ticks_off, _, _ = burst(off, "kill switch")
    for i in range(len(prompts)):
        a, b = res_on[i]["tokens"], res_off[i]["tokens"]
        first = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                     None if a == b else min(len(a), len(b)))
        print(f"stream {i}: speculative tokens == kill switch tokens: "
              f"{first is None}"
              f"{'' if first is None else f' (first difference at {first})'}",
              flush=True)
        check(first is None, f"stream {i}: speculation changed the tokens")
    n_tok = len(prompts) * max_new
    print(f"serve: speculative ticks={ticks_on} tokens_per_s="
          f"{n_tok / wall_on:.6g}; kill switch ticks={ticks_off} "
          f"tokens_per_s={n_tok / wall_off:.6g} [{smi_line}]", flush=True)
    del off
    gc.collect()
    torch.cuda.empty_cache()

    # 4c: the oracle drafter, every third position corrupted
    oracle_engine(model, knobs, prompts, res_off, max_new, burst, smi_line)
    return model, prompts, max_new


def oracle_engine(model, knobs, prompts, res_off, max_new, burst, smi_line):
    """Phase 4c: the speculative engine with `_draft_for_slot` replaced by
    a drafter proposing the kill switch's own tokens (`res_off`), the one
    for every output position p with p % 3 == 2 corrupted. A proposal's
    predicted acceptance is its run of uncorrupted drafts."""
    import gc

    import torch

    from paddle_tpu_torch.inference import gateway as gw

    eng = gw.build_engine(model, **knobs)
    vocab = eng.cfg.vocab_size
    refs = {tuple(p): res_off[i]["tokens"] for i, p in enumerate(prompts)}
    proposals = []                       # (drafts, predicted accepted)

    def oracle(i, budget):
        slot = eng.slots[i]
        req = slot.req
        ref = refs.get(tuple(req.prompt))
        k = min(slot.spec_k, budget, req.max_new_tokens - slot.produced - 1,
                eng.S - 1 - slot.length)
        if ref is None or k <= 0:
            return []
        m0 = len(req.output)
        pos = range(m0, min(m0 + k, len(ref)))
        drafts = [(ref[m] + 1) % vocab if m % 3 == 2 else ref[m]
                  for m in pos]
        good = next((n for n, m in enumerate(pos) if m % 3 == 2),
                    len(drafts))
        if drafts:
            proposals.append((len(drafts), good))
        return drafts

    eng._draft_for_slot = oracle
    res, _, _, _, drafted, accepted = burst(eng, "oracle drafter")
    want_d = sum(n for n, _ in proposals)
    want_a = sum(g for _, g in proposals)
    multi = sum(1 for _, g in proposals if g >= 1)
    rolled = sum(1 for n, g in proposals if g < n)
    print(f"oracle: drafted={drafted} (proposed {want_d}) accepted="
          f"{accepted} (predicted {want_a}) multi-token commits={multi} "
          f"rollbacks={rolled} pool free {eng.pool.n_free}/"
          f"{eng.pool.n_pages - 1} [{smi_line}]", flush=True)
    for i in range(len(prompts)):
        check(res[i]["tokens"] == res_off[i]["tokens"],
              f"oracle stream {i}: tokens differ from the kill switch's")
    check(drafted == want_d and accepted == want_a,
          f"oracle: drafted/accepted {drafted}/{accepted}, predicted "
          f"{want_d}/{want_a}")
    check(multi >= 1 and rolled >= 1, f"oracle: {multi} multi-token "
          f"commits and {rolled} rollbacks (need one of each)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def verify_lm_head_check(L, engine, cfg, smi_line):
    """The verify lm-head at llama_7b width on the engine's weights:
    `_verify_logits` over the verify case's rows (`RAGGED_ROWS`) against
    the last-row product `_last_row_logits` of each slot's rows, under
    torch.equal; a [4, 1, 4096] product's rows against the same rows
    in another order (the batch's other rows must not matter); one
    [20, 1, 4096] product against the K products, printed only."""
    import torch

    rows = RAGGED_ROWS["verify"]
    K = engine.max_draft_tokens + 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    h = torch.randn((128, cfg.hidden_size), generator=gen,
                    device="cuda").to(engine.dtype)
    qs, ql = (torch.tensor([r[i] for r in rows], dtype=torch.int32,
                           device="cuda") for i in range(2))
    with torch.no_grad():
        got = L._verify_logits(engine.state, h, qs, ql, K)
        same = [bool(torch.equal(got[:, i], L._last_row_logits(
            engine.state, h, qs, ql - (K - 1 - i)))) for i in range(K)]
        last = L._last_row_logits(engine.state, h, qs, ql)
        perm = torch.tensor([2, 0, 3, 1], device="cuda")
        moved = L._last_row_logits(engine.state, h, qs[perm], ql[perm])
        order_free = bool(torch.equal(moved, last[perm]))
        idx = (qs[:, None]
               + torch.arange(K, device="cuda")[None, :]).reshape(-1)
        one = L._lm_head(engine.state, h[idx][:, None]).float()[:, 0]
        one_same = bool(torch.equal(one.reshape(len(rows), K, -1), got))
    print(f"verify lm-head: K products equal to the last-row products "
          f"{same}; a product's rows independent of the others' order "
          f"{order_free}; one [{len(rows) * K}, 1, {cfg.hidden_size}] "
          f"product equal to the K products {one_same} (not used) "
          f"[{smi_line}]", flush=True)
    check(all(same), "verify lm-head differs from the last-row products")
    check(order_free, "a lm-head product row depends on the batch's "
          "other rows")


def generate_phase(report, model, smi_line):
    """`generate` at llama_7b: GEN_BATCH prompts of GEN_PROMPT tokens,
    GEN_NEW new tokens, greedy. Prefill ms is a generate of one token;
    per-token decode ms is the rest of a GEN_NEW-token generate over its
    GEN_NEW - 1 decode steps, both by CUDA events."""
    import numpy as np
    import torch

    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.models import llama as L

    cfg = model.cfg
    L_ = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))).to("cuda")
    model.generate(ids, max_new_tokens=2)        # warm-up

    def run(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = model.generate(ids, max_new_tokens=n)
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    _, prefill_ms = run(1)
    kernels = {"paged_decode_attention": kpa.paged_decode_attention,
               "rms_norm": krn.rms_norm, "swiglu": ksw.swiglu}
    for fn in kernels.values():
        fn.launches = 0
    out, total_ms = run(GEN_NEW)
    launches = {name: fn.launches for name, fn in kernels.items()}
    decode_ms = (total_ms - prefill_ms) / (GEN_NEW - 1)
    check(out.shape == (GEN_BATCH, GEN_NEW) and out.dtype == torch.int32
          and out.is_cuda, f"generate returned {tuple(out.shape)} "
          f"{out.dtype} on {out.device}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generate produced an out-of-vocab token")
    print(f"generate: ids {tuple(out.shape)} {out.dtype} prompt "
          f"{GEN_BATCH}x{GEN_PROMPT} prefill_ms={prefill_ms:.6g} "
          f"decode_ms_per_token={decode_ms:.6g} decode_tokens_per_s="
          f"{GEN_BATCH * 1e3 / decode_ms:.6g} total_ms={total_ms:.6g} "
          f"[{smi_line}]", flush=True)
    want = {"paged_decode_attention": L_ * (GEN_NEW - 1),
            "rms_norm": (2 * L_ + 1) * GEN_NEW, "swiglu": L_ * GEN_NEW}
    for name, n in launches.items():
        print(f"launches {name} (generate): {n} (expected {want[name]})",
              flush=True)
        check(n == want[name], f"{name} launched {n} times in generate, "
                               f"expected {want[name]}")
        add_launches(report, name, "generate", n)

    # one decode step after the prompt, kernel route against plain route
    state = dict(model.state_dict())
    wls = L._gather_layer_weights(state, cfg)
    S = -(-(GEN_PROMPT + GEN_NEW) // 16) * 16
    ck = torch.zeros((L_, GEN_BATCH, S, cfg.kv_heads, cfg.head_dim),
                     dtype=state["model.embed_tokens"].dtype, device="cuda")
    cv = torch.zeros_like(ck)
    zeros = torch.zeros((GEN_BATCH,), dtype=torch.int32, device="cuda")
    lg, _, _ = L._forward_with_cache(state, cfg, ids, ck, cv, zeros, wls=wls)
    tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    cur = torch.full((GEN_BATCH,), GEN_PROMPT, dtype=torch.int32,
                     device="cuda")
    lg_k, _, _ = L._forward_with_cache(state, cfg, tok, ck.clone(),
                                       cv.clone(), cur, wls=wls)
    torch.cuda.synchronize()
    with plain_routes():
        lg_p, _, _ = L._forward_with_cache(state, cfg, tok, ck.clone(),
                                           cv.clone(), cur, wls=wls)
    torch.cuda.synchronize()
    lg_k, lg_p = lg_k[:, -1], lg_p[:, -1]
    diff = (lg_k - lg_p).abs()
    err, mean = diff.max().item(), diff.mean().item()
    agree = int((lg_k.argmax(-1) == lg_p.argmax(-1)).sum())
    ok = (err <= GEN_STEP_ATOL and mean <= GEN_STEP_MEAN_ATOL
          and bool(torch.isfinite(lg_k).all()))
    print(f"generate decode step: kernel vs plain route logits "
          f"max_abs_err={err:.6g} (limit {GEN_STEP_ATOL:g}) mean_abs_err="
          f"{mean:.6g} (limit {GEN_STEP_MEAN_ATOL:g}) max|logit|="
          f"{lg_p.abs().max().item():.6g} argmax agree {agree}/{GEN_BATCH} "
          f"{'ok' if ok else 'MISS'}", flush=True)
    check(ok, "the generate decode step's kernel route disagrees with the "
              "plain route")
    decode_breakdown(L, state, cfg, tok, ck, cv, cur, wls, smi_line)
    del ck, cv, state, wls
    torch.cuda.empty_cache()


def decode_breakdown(L, state, cfg, tok, ck, cv, cur, wls, smi_line):
    """Where one generate decode step's time goes: the step timed with
    CUDA events (re-running it rewrites the same cache slot), the host's
    enqueue time (the step's Python and launches, no synchronisation),
    then three steps traced by torch.profiler, device time summed by
    kernel group; busy share = device time per step over the step's
    event time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        L._forward_with_cache(state, cfg, tok, ck, cv, cur, wls=wls)

    step_ms = time_ms(step, 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        step()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    groups, others = _device_ms(prof, _DECODE_GROUPS, "other")
    busy = sum(groups.values()) / n
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / n
    print(f"decode step: step_ms={step_ms:.6g} host_enqueue_ms="
          f"{enqueue_ms:.6g} device_kernels_per_step={kernels:.6g} "
          f"[{smi_line}]", flush=True)
    if busy == 0.0:
        print("decode step profile: not measured (the profiler saw no "
              "device time)", flush=True)
        return
    order = [g for _, g in _DECODE_GROUPS] + ["other"]
    parts = " ".join(f"{g}={groups.get(g, 0.0) / n:.6g}"
                     for g in dict.fromkeys(order))
    print(f"decode step profile (device ms per step): {parts} "
          f"total={busy:.6g} busy_share={busy / step_ms:.4f} "
          f"[{smi_line}]", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print("decode step profile, largest other kernels (ms per step): "
          + "; ".join(f"{k[:60]}={ms / n:.4g}" for k, ms in top), flush=True)


def serve_burst(engine, prompts, max_new, kernels, what, counters,
                in_order=False):
    """The engine behind the HTTP gateway: one warm-up request, then the
    prompts as concurrent streams of max_new tokens, each of which must
    be served whole. The kernels' launch counters are zeroed after the
    warm-up and read when the burst ends. in_order: no tick runs until
    every prompt is queued, in the order given, so that two engines see
    the same admissions and prefill chunks. Returns (results, wall
    seconds, launches, the change in `counters()` over the burst)."""
    from paddle_tpu_torch.inference import gateway as gw

    runner = gw.EngineRunner(engine)
    gateway = gw.ServingGateway(runner, port=0)
    port = gateway.start()
    try:
        warm = {}
        post_stream(port, [1, 2, 3, 4, 5], 2, warm, 0)
        check(warm[0]["end"] and warm[0]["end"][1]["status"] == "served",
              f"warm-up {what} did not serve: {warm[0]['end']} "
              f"(engine fault: {gateway.runner.fatal!r})")
        for fn in kernels.values():
            fn.launches = 0
        before = counters()
        results = {}
        t_burst = time.perf_counter()
        threads = [threading.Thread(target=post_stream,
                                    args=(port, p, max_new, results, i))
                   for i, p in enumerate(prompts)]
        with (runner.lock if in_order else contextlib.nullcontext()):
            for i, t in enumerate(threads):
                t.start()
                while in_order and len(runner._inbox) <= i:
                    check(time.perf_counter() - t_burst < 60,
                          f"{what} {i} was not queued")
                    time.sleep(0.001)
        for t in threads:
            t.join(timeout=600)
            check(not t.is_alive(), f"a {what} thread did not finish")
        wall = time.perf_counter() - t_burst
        launches = {name: fn.launches for name, fn in kernels.items()}
        delta = tuple(b - a for a, b in zip(before, counters()))
    finally:
        gateway.drain(timeout=60)
        gateway.stop()
    vocab = engine.cfg.vocab_size
    for i, p in enumerate(prompts):
        r = results.get(i)
        check(r is not None, f"{what} {i} returned nothing")
        check(r["end"] is not None and r["end"][0] == "end"
              and r["end"][1]["status"] == "served",
              f"{what} {i} (prompt {len(p)}) ended {r['end']}")
        check(len(r["tokens"]) == max_new,
              f"{what} {i} got {len(r['tokens'])} tokens, not {max_new}")
        check(all(0 <= t < vocab for t in r["tokens"]),
              f"{what} {i} produced an out-of-vocab token")
    check(engine.pool.n_free == engine.pool.n_pages - 1,
          f"KV pool not fully free after the {what}s drained")
    return results, wall, launches, delta


def bucketed_phase(report, model, prompts, max_new, smi_line):
    """The serving phase's burst through the gateway over the bucketed
    engine (`ragged=False`, default buckets)."""
    import torch

    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    L_ = model.cfg.num_hidden_layers
    engine = gw.build_engine(model, max_batch=4, max_seq=1024, page_size=16,
                             ragged=False, device="cuda")
    check(not engine._ragged and engine._pcache is None,
          "ragged=False did not select the bucketed regime")
    kernels = {"paged_decode_attention": kpa.paged_decode_attention,
               "rms_norm": krn.rms_norm, "swiglu": ksw.swiglu}
    results, wall, launches, (decodes, prefills, ticks) = serve_burst(
        engine, prompts, max_new, kernels, "bucketed request",
        lambda: (engine.decode_steps, sum(engine.prefill_calls.values()),
                 engine.ticks))
    fwd = decodes + prefills
    want = {"paged_decode_attention": L_ * decodes,
            "rms_norm": (2 * L_ + 1) * fwd, "swiglu": L_ * fwd}
    for name, n in launches.items():
        print(f"launches {name} (bucketed serving): {n} (decode ticks "
              f"{decodes}, prefill calls {prefills} -> expected "
              f"{want[name]})", flush=True)
        check(n == want[name] and n > 0,
              f"{name} launched {n} times in bucketed serving, expected "
              f"{want[name]}")
        add_launches(report, name, "bucketed_serving", n)
    ttfts = [results[i]["ttft_s"] for i in range(len(prompts))]
    n_tok = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
    print(f"bucketed serve: ticks={ticks} decode_ticks={decodes} "
          f"prefill_calls={prefills} (by (bucket, k), with the warm-up's: "
          f"{sorted(engine.prefill_calls.items())}) prompts="
          f"{[len(p) for p in prompts]} max_new={max_new} "
          f"preemptions={engine.preemptions} [{smi_line}]", flush=True)
    print(f"bucketed serve: ttft_ms={[round(1e3 * t, 3) for t in ttfts]} "
          f"wall_s={wall:.6g} tokens_per_s={n_tok / wall:.6g} "
          f"[{smi_line}]", flush=True)
    del engine
    torch.cuda.empty_cache()


SLO_KNOBS = dict(max_batch=4, max_seq=1024, page_size=16, max_chunk_tokens=64,
                 device="cuda")


def post_json(port, body, path="/v1/generate", method="POST"):
    """One non-streamed request: (HTTP status, headers, JSON body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path,
                 body=None if body is None else json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    doc = json.loads(resp.read() or b"{}")
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, doc


def queued_posts(runner, port, posts, what, headers=None):
    """Start one post_stream thread per (prompt, max_new, extra) while
    the tick thread is held, so that every request is queued, in order,
    before the next tick; `headers` maps a post's index to its request
    headers. Returns (threads, results)."""
    results = {}
    threads = [threading.Thread(target=post_stream,
                                args=(port, p, n, results, i),
                                kwargs={"extra": extra,
                                        "headers": (headers or {}).get(i)})
               for i, (p, n, extra) in enumerate(posts)]
    t0 = time.perf_counter()
    with runner.lock:
        for i, t in enumerate(threads):
            t.start()
            while len(runner._inbox) <= i:
                check(time.perf_counter() - t0 < 60,
                      f"{what}: request {i} was not queued")
                time.sleep(0.001)
    return threads, results


def join_all(threads, what):
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), f"a {what} thread did not finish")


def drive(eng, reqs, on_tick=None, cap=4000):
    """Queue `reqs` and tick the engine directly until it drains;
    on_tick(eng, tick) runs after each step. Returns the ticks."""
    for r in reqs:
        eng.add_request(r)
    n = 0
    while eng.has_work and n < cap:
        eng.step()
        n += 1
        if on_tick is not None:
            on_tick(eng, n)
    check(not eng.has_work, "the engine did not drain")
    return n


def free_engine(*_):
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def slo_phase(report, model, prompts, max_new, smi_line):
    """Phase 6b: the SLO layer, armed by default, on the serving
    phases' llama_7b (module docstring)."""
    slo_parity(report, model, prompts, max_new, smi_line)
    slo_gateway(model, smi_line)
    slo_kernel_nonfinite()
    for ragged in (True, False):
        slo_nan_pages(report, model, ragged, smi_line)
    slo_tick_fault(model, smi_line)


def slo_parity(report, model, prompts, max_new, smi_line):
    """(a) phase 4's burst with the layer's inert defaults and under
    FLAGS_serving_slo=0, twice each (armed, off, off, armed): tokens and
    per-tick trace identical; step ms, tokens/s and the layer's host ms
    a tick, each order's mean."""
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    L_ = model.cfg.num_hidden_layers
    kernels = {"rms_norm": krn.rms_norm, "swiglu": ksw.swiglu,
               "ragged_paged_attention": krpa.ragged_paged_attention}

    def run(eng, what, path=None):
        trace, step_s, slo_s, marks = [], [], [0.0], []
        real_step = eng.step

        def step():
            t = time.perf_counter()
            done = real_step()
            step_s.append(time.perf_counter() - t)
            trace.append((eng.last_packed_tokens, len(done),
                          eng.preemptions))
            return done

        def timed(fn):
            def run_timed():
                t = time.perf_counter()
                fn()
                slo_s[0] += time.perf_counter() - t
            return run_timed

        eng.step = step
        if eng._slo:
            eng._slo_pre_tick = timed(eng._slo_pre_tick)
            eng._slo_post_tick = timed(eng._slo_post_tick)

        def counters():
            marks.append((len(step_s), slo_s[0]))
            return (eng.model_steps,)

        results, wall, launches, (steps,) = serve_burst(
            eng, prompts, max_new, kernels, what, counters, in_order=True)
        (n0, s0), (n1, s1) = marks
        want = {"rms_norm": steps * (2 * L_ + 1), "swiglu": steps * L_,
                "ragged_paged_attention": steps * L_}
        for name, n in launches.items():
            print(f"launches {name} ({what}): {n} (steps {steps} -> "
                  f"expected {want[name]})", flush=True)
            check(n == want[name] and n > 0,
                  f"{name} launched {n} times in the {what}, expected "
                  f"{want[name]}")
            if path:
                add_launches(report, name, path, n)
        ticks = n1 - n0
        step_ms = 1e3 * sum(step_s[n0:n1]) / ticks
        slo_ms = 1e3 * (s1 - s0) / ticks
        n_tok = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
        print(f"slo (a) {what}: ticks={ticks} step_ms={step_ms:.6g} "
              f"tokens_per_s={n_tok / wall:.6g} slo_host_ms_per_tick="
              f"{slo_ms:.6g} quarantines={eng.quarantines} [{smi_line}]",
              flush=True)
        check(eng.quarantines == 0, f"{what}: {eng.quarantines} "
              f"quarantines on a clean run")
        return results, trace, step_ms, n_tok / wall, slo_ms

    def engine(slo):
        if slo:
            eng = gw.build_engine(model, **SLO_KNOBS)
            check(eng._slo and eng._spec, "the default engine did not arm "
                  "the SLO layer and speculation")
            return eng
        fcore.set_flags({"FLAGS_serving_slo": False})
        try:
            eng = gw.build_engine(model, **SLO_KNOBS)
        finally:
            fcore.set_flags({"FLAGS_serving_slo": True})
        check(not eng._slo, "FLAGS_serving_slo=0 armed the SLO layer")
        return eng

    # armed, kill switch, kill switch, armed: the two orders cancel a
    # drift of the host's speed through the phase
    runs = []
    for i, slo in enumerate((True, False, False, True)):
        eng = engine(slo)
        what = f"SLO {'armed' if slo else 'kill switch'} run {i + 1}"
        runs.append((slo,) + run(eng, what, "slo_serving" if i == 0
                                 else None))
        del eng
        free_engine()
    res_on, tr_on = runs[0][1:3]
    for i, (slo, res, trace, step_ms, tok_s, slo_ms) in enumerate(runs):
        same = [res_on[k]["tokens"] == res[k]["tokens"]
                for k in range(len(prompts))]
        print(f"slo (a) run {i + 1} ({'armed' if slo else 'kill switch'}): "
              f"tokens of each stream == run 1's: {same}; per-tick trace "
              f"== run 1's: {trace == tr_on} ({len(trace)} ticks)",
              flush=True)
        check(all(same), f"run {i + 1}: the SLO layer changed the tokens")
        check(trace == tr_on, f"run {i + 1}: the SLO layer changed the "
              f"per-tick trace")

    def mean(k, slo):
        vals = [r[k] for r in runs if r[0] == slo]
        return sum(vals) / len(vals)

    print(f"slo (a) step_ms armed {mean(3, True):.6g} kill switch "
          f"{mean(3, False):.6g}; tokens_per_s armed {mean(4, True):.6g} "
          f"kill switch {mean(4, False):.6g}; slo_host_ms_per_tick "
          f"{mean(5, True):.6g} (runs 1 and 4 against 2 and 3) "
          f"[{smi_line}]", flush=True)


def slo_gateway(model, smi_line):
    """(b) priority order, 504, 429 with a bounded Retry-After and
    degradation, through the gateway."""
    import numpy as np

    from paddle_tpu_torch.inference import gateway as gw

    vocab = model.cfg.vocab_size
    rng = np.random.RandomState(11)

    def prompt(n):
        return rng.randint(1, vocab, n).tolist()

    knobs = dict(SLO_KNOBS, max_batch=1, max_queue_tokens=600)
    eng = gw.build_engine(model, **knobs)
    runner = gw.EngineRunner(eng)
    gateway = gw.ServingGateway(runner, port=0)
    port = gateway.start()
    try:
        # priority: three priority-0 requests, then a priority-1 one, all
        # queued before a tick; one slot serves them one at a time
        posts = [(prompt(16), 8, None) for _ in range(3)]
        posts.append((prompt(16), 8, {"priority": 1}))
        threads, res = queued_posts(runner, port, posts, "priority")
        join_all(threads, "priority")
        for i in range(4):
            check(res[i]["end"] and res[i]["end"][1]["status"] == "served",
                  f"priority request {i} ended {res[i]['end']}")
        order = sorted(range(4), key=lambda i: res[i]["t_end"])
        print(f"slo (b) finish order (3 = priority 1, queued last): "
              f"{order}", flush=True)
        check(order == [3, 0, 1, 2], f"finish order {order}, not the "
              f"priority-1 request first and the rest in FIFO order")
        # a deadline that has passed before the first tick
        status, _, doc = post_json(port, {"prompt": prompt(16),
                                          "max_new_tokens": 8,
                                          "deadline_s": 1e-9,
                                          "stream": False})
        print(f"slo (b) deadline_s=1e-9: HTTP {status} {doc.get('status')}"
              f" ({doc.get('error')})", flush=True)
        check(status == 504 and doc["status"] == "deadline_missed"
              and "DeadlineExceeded" in doc["error"],
              f"deadline request answered {status} {doc}")
        # the queue bound: two 400-token prompts queued together against
        # a bound of 600
        got = {}

        def post(i, body):
            got[i] = post_json(port, body)

        bodies = [{"prompt": prompt(400), "max_new_tokens": 4,
                   "stream": False} for _ in range(2)]
        threads = [threading.Thread(target=post, args=(i, b))
                   for i, b in enumerate(bodies)]
        t0 = time.perf_counter()
        with runner.lock:
            for i, t in enumerate(threads):
                t.start()
                while len(runner._inbox) <= i:
                    check(time.perf_counter() - t0 < 60,
                          "queue-bound request was not queued")
                    time.sleep(0.001)
        join_all(threads, "queue-bound")
        (s0, _, d0), (s1, h1, d1) = got[0], got[1]
        retry = h1.get("Retry-After")
        print(f"slo (b) queue bound 600: first HTTP {s0} "
              f"{d0.get('status')}, second HTTP {s1} Retry-After={retry} "
              f"retry_after_s={d1.get('retry_after_s')}", flush=True)
        check(s0 == 200 and d0["status"] == "served",
              f"the request under the bound answered {s0} {d0}")
        check(s1 == 429 and retry is not None and retry.isdigit()
              and 1 <= int(retry) <= 60,
              f"the request over the bound answered {s1}, Retry-After "
              f"{retry!r}")
        check(eng.quarantines == 0 and eng.pool.n_free ==
              eng.pool.n_pages - 1, "gateway engine: quarantines or pages "
              "left after the priority, deadline and bound checks")
    finally:
        gateway.drain(timeout=60)
        gateway.stop()
    del eng, runner, gateway
    free_engine()

    # degradation: 20 allocatable pages (320 tokens); a 260-token prompt
    # holds 17 of them (0.85) and its decode an 18th
    eng = gw.build_engine(model, **dict(SLO_KNOBS, max_batch=2,
                                        total_pages=21))
    chunks = []
    real_step = eng.step

    def step():
        done = real_step()
        chunks.append(eng._eff_chunk)
        return done

    eng.step = step
    runner = gw.EngineRunner(eng)
    gateway = gw.ServingGateway(runner, port=0)
    port = gateway.start()
    try:
        posts = [(prompt(260), 16, None), (prompt(8), 8, None)]
        threads, res = queued_posts(runner, port, posts, "degradation")
        join_all(threads, "degradation")
        status, _, health = post_json(port, None, path="/healthz",
                                      method="GET")
    finally:
        gateway.drain(timeout=60)
        gateway.stop()
    e = health["engine"]
    print(f"slo (b) degradation: effective chunk a tick {chunks}; /healthz "
          f"degraded={e['degraded']} effective_chunk_tokens="
          f"{e['effective_chunk_tokens']} of {e['max_chunk_tokens']}, "
          f"pages free {e['kv_pages']['free']}/{e['kv_pages']['total']}",
          flush=True)
    for i in range(2):
        check(res[i]["end"] and res[i]["end"][1]["status"] == "served",
              f"degradation request {i} ended {res[i]['end']}")
    check(32 in chunks, "the chunk budget never halved to 32")
    check(e["degraded"] and e["effective_chunk_tokens"] <= 32,
          "/healthz does not show the degraded budget")
    check(e["kv_pages"]["free"] == e["kv_pages"]["total"],
          "pages left after the degradation run")
    del eng, runner, gateway
    free_engine()


def slo_kernel_nonfinite():
    """(c), first on the kernels alone: rows 9 and 13 hold
    `testing.nonfinite_checks` in bf16 and f32 (stale NaN and inf past
    the lengths do not reach the output; a NaN key reaches its own
    sequence's rows and no other's)."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa

    for dtype in (torch.bfloat16, torch.float32):
        for label, ok in testing.nonfinite_checks(krpa, kpa, dtype, "cuda"):
            print(f"slo (c) kernel {label}: {'ok' if ok else 'MISS'}",
                  flush=True)
            check(ok, f"kernel non-finite semantics: {label}")


def slo_nan_pages(report, model, ragged, smi_line):
    """(c) NaN in a victim's KV pages after its prefill: quarantined
    exactly through the route's attention kernel, the others
    token-identical to a clean run, and a request served on the
    reclaimed pages token-identical to a fresh engine's."""
    import numpy as np
    import torch

    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.inference.serving import GenerationRequest
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    route = "ragged" if ragged else "bucketed"
    attn = (krpa.ragged_paged_attention if ragged
            else kpa.paged_decode_attention)
    kernels = {"rms_norm": krn.rms_norm, "swiglu": ksw.swiglu,
               attn.__name__: attn}
    knobs = dict(SLO_KNOBS, ragged=ragged)
    rng = np.random.RandomState(23)
    vocab = model.cfg.vocab_size
    # the victim comes last and its prompt fills no page: its pages are
    # not indexed by the prefix cache (they return to the free list)
    # and the others' prompt pages are all allocated before it fails
    prompts = [rng.randint(1, vocab, n).tolist() for n in (40, 60, 12)]
    late = rng.randint(1, vocab, 5).tolist()

    def reqs():
        return [GenerationRequest(list(p), max_new_tokens=16)
                for p in prompts]

    clean_eng = gw.build_engine(model, **knobs)
    clean = reqs()
    drive(clean_eng, clean)
    check(clean_eng.quarantines == 0, f"{route}: a clean run quarantined")
    del clean_eng
    free_engine()

    eng = gw.build_engine(model, **knobs)
    work = reqs()
    victim = work[2]
    hit = {}

    def poison(e, tick):
        if hit or victim.status != "running":
            return
        i = next(j for j, s in enumerate(e.slots) if s.req is victim)
        if e.slots[i].pending or not victim.output:
            return                       # prefill not done yet
        pages = list(e.slot_pages[i])
        idx = torch.tensor(pages, device=e.device)
        e.k_pool[:, :, idx] = float("nan")
        e.v_pool[:, :, idx] = float("nan")
        hit.update(tick=tick, pages=pages, q0=e.quarantines)

    for fn in kernels.values():
        fn.launches = 0
    steps0 = (eng.model_steps, eng.decode_steps,
              sum(eng.prefill_calls.values()))
    drive(eng, work, on_tick=poison)
    steps = (eng.model_steps - steps0[0], eng.decode_steps - steps0[1],
             sum(eng.prefill_calls.values()) - steps0[2])
    launches = {n: fn.launches for n, fn in kernels.items()}
    check(bool(hit), f"{route}: the victim's prefill never completed")
    others_same = [r.output == c.output for r, c in zip(work[:2], clean[:2])]
    print(f"slo (c) {route}: NaN in the victim's pages {hit['pages']} after "
          f"tick {hit['tick']}; victim {victim.status} ({victim.error}); "
          f"quarantines {eng.quarantines}; other streams token-identical "
          f"to the clean run: {others_same}; launches {launches} "
          f"(steps {steps}) [{smi_line}]", flush=True)
    check(victim.status == "failed" and victim.error == "non-finite logits",
          f"{route}: the victim ended {victim.status} ({victim.error})")
    check(eng.quarantines == 1, f"{route}: {eng.quarantines} quarantines, "
          f"not exactly the victim")
    check(all(r.status == "served" for r in work[:2]) and all(others_same),
          f"{route}: another stream changed or failed")
    L_ = model.cfg.num_hidden_layers
    fwd = steps[0] + steps[1] + steps[2]
    want = ({"rms_norm": (2 * L_ + 1) * fwd, "swiglu": L_ * fwd,
             attn.__name__: L_ * (steps[0] if ragged else steps[1])})
    for name, n in launches.items():
        check(n == want[name] and n > 0, f"{route}: {name} launched {n} "
              f"times, expected {want[name]}")
        add_launches(report, name, f"slo_nan_{route}", n)
    # a new request on the victim's reclaimed pages: they go to the head
    # of the free list, so its first allocation takes them
    free = eng.pool._free
    for p in hit["pages"]:
        check(p in free, f"{route}: victim page {p} was not reclaimed")
        free.remove(p)
    free.extend(reversed(hit["pages"]))
    got = GenerationRequest(list(late), max_new_tokens=16)
    seen = set()

    def pages_of(e, tick):
        for j, s in enumerate(e.slots):
            if s.req is got:
                seen.update(e.slot_pages[j])

    drive(eng, [got], on_tick=pages_of)
    del eng
    free_engine()
    fresh_eng = gw.build_engine(model, **knobs)
    want_req = GenerationRequest(list(late), max_new_tokens=16)
    drive(fresh_eng, [want_req])
    del fresh_eng
    free_engine()
    reused = sorted(seen & set(hit["pages"]))
    print(f"slo (c) {route}: a request on the reclaimed pages {reused} "
          f"(stale NaN past its length): tokens identical to a fresh "
          f"engine's: {got.output == want_req.output} ({got.status})",
          flush=True)
    check(reused, f"{route}: the new request took none of the victim's "
          f"pages")
    check(got.status == "served" and got.output == want_req.output,
          f"{route}: the request on reclaimed pages differs from a fresh "
          f"engine's")


def slo_tick_fault(model, smi_line):
    """(d) FLAGS_fault_inject=serving.tick:raise@3 fails the latest
    admission alone."""
    import numpy as np

    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.inference.serving import GenerationRequest

    rng = np.random.RandomState(31)
    prompts = [rng.randint(1, model.cfg.vocab_size, 20).tolist()
               for _ in range(3)]

    def run():
        eng = gw.build_engine(model, **dict(SLO_KNOBS, max_batch=3))
        reqs = [GenerationRequest(list(p), max_new_tokens=8)
                for p in prompts]
        drive(eng, reqs)
        out = (reqs, eng.quarantines, eng.pool.n_free == eng.pool.n_pages - 1)
        del eng
        free_engine()
        return out

    clean, q_clean, _ = run()
    check(q_clean == 0, "the clean run quarantined a request")
    fcore.set_flags({"FLAGS_fault_inject": "serving.tick:raise@3"})
    try:
        reqs, quarantines, whole = run()
    finally:
        fcore.set_flags({"FLAGS_fault_inject": ""})
    same = [r.output == c.output for r, c in zip(reqs[:2], clean[:2])]
    print(f"slo (d) serving.tick:raise@3: statuses "
          f"{[r.status for r in reqs]}, the failed one's error "
          f"{reqs[2].error!r}; quarantines {quarantines}; the others "
          f"token-identical to the clean run: {same}; pool whole {whole}",
          flush=True)
    check([r.status for r in reqs] == ["served", "served", "failed"]
          and "FaultInjected" in (reqs[2].error or ""),
          "the tick fault did not fail exactly the latest admission")
    check(quarantines == 1 and all(same) and whole,
          "the tick fault touched another stream or left pages")


def trace_phase(report, model, prompts, max_new, smi_line):
    """Phase 6c: request tracing and the serving telemetry, armed by
    default, on the serving phases' llama_7b (module docstring)."""
    trace_parity(report, model, prompts, max_new, smi_line)
    trace_gateway(model, prompts, max_new, smi_line)
    trace_flight_recorder(model, smi_line)


def int8_phase(report, model, prompts, max_new, smi_line):
    """Phase 6d: weight-only int8 serving on the serving phases'
    llama_7b, then the incubate functions (module docstring). Leaves
    the dequantized int8 weights in `model`."""
    import gc

    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    from paddle_tpu_torch.models import llama as L

    cfg = model.cfg
    L_, H = cfg.num_hidden_layers, cfg.hidden_size
    gc.collect()
    torch.cuda.empty_cache()
    # (a) serve's engine, int8, speculation armed
    engine = gw.build_engine(model, quantize="int8", **SLO_KNOBS)
    check(engine._quantized and engine._spec,
          "quantize='int8' did not arm int8 on the default engine")
    K = engine.max_draft_tokens + 1
    q8 = [v for v in engine.state.values() if isinstance(v, kwol.QuantWeight)]
    q_bytes = sum(w.q.numel() + 4 * w.scale.numel() for w in q8)
    rest = sum(v.numel() * v.element_size() for v in engine.state.values()
               if isinstance(v, torch.Tensor))
    print(f"int8 (a): {len(q8)} int8 products, {q_bytes / 1e9:.6g} GB int8 "
          f"+ scales, {rest / 1e9:.6g} GB kept in bf16/f32 (embedding, "
          f"norms) [{smi_line}]", flush=True)
    check(len(q8) == 4 * L_ + 1, f"{len(q8)} quantized weights, expected "
          f"{4 * L_ + 1} (4 a layer and the lm head)")
    captured = []
    real_fn = engine._ragged_fn

    def capturing_fn():
        step = real_fn()

        def run(state, toks, k_pool, v_pool, page_ids, offs, pos,
                page_table, q_start, q_len, kv_len, produce, verify, g):
            if not captured and bool((q_len > 1).any()) and int(
                    (q_len > 0).sum()) >= 3:
                captured.append(([t.clone() for t in (
                    toks, pos, page_ids, offs, page_table, q_start, q_len,
                    kv_len)], verify.clone()))
            return step(state, toks, k_pool, v_pool, page_ids, offs, pos,
                        page_table, q_start, q_len, kv_len, produce, verify,
                        g)

        return run

    engine._ragged_fn = capturing_fn
    kernels = {"weight_only_linear": kwol.weight_only_linear,
               "swiglu": ksw.swiglu, "rms_norm": krn.rms_norm,
               "ragged_paged_attention": krpa.ragged_paged_attention}
    res_a, wall, launches, (steps, ticks, drafted, accepted) = serve_burst(
        engine, prompts, max_new, kernels, "int8 request",
        lambda: (engine.model_steps, engine.ticks, engine.spec_drafted,
                 engine.spec_accepted), in_order=True)
    want = {"weight_only_linear": steps * testing.int8_step_launches(L_, K),
            "swiglu": 0, "rms_norm": steps * (2 * L_ + 1),
            "ragged_paged_attention": steps * L_}
    for name, n in launches.items():
        print(f"launches {name} (int8 serving): {n} (steps {steps} -> "
              f"expected {want[name]})", flush=True)
        check(n == want[name], f"{name} launched {n} times in int8 "
              f"serving, expected {want[name]}")
        if n:
            add_launches(report, name, "int8_serving", n)
    ttfts = [res_a[i]["ttft_s"] for i in range(len(prompts))]
    n_tok = sum(len(res_a[i]["tokens"]) for i in range(len(prompts)))
    print(f"int8 (a) serve: ticks={ticks} steps={steps} drafted={drafted} "
          f"accepted={accepted} ttft_ms={[round(1e3 * t, 3) for t in ttfts]} "
          f"wall_s={wall:.6g} tokens_per_s={n_tok / wall:.6g} "
          f"[{smi_line}]", flush=True)
    check(captured, "no mixed int8 step with 3+ live sequences was captured")
    args, verify = captured[0]
    kw = dict(verify_rows=K, row_tiles=verify, wls=engine._wls)
    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        L._ragged_step_paged(engine.state, cfg, args[0], args[1],
                             engine.k_pool, engine.v_pool, *args[2:], **kw)
        torch.cuda.synchronize()
        grow = torch.cuda.max_memory_allocated() - base
    o_bf16 = H * H * 2
    print(f"int8 (a): a ragged step's peak allocation above the state and "
          f"pools {grow / 1e6:.6g} MB (limit: o_proj in bf16, "
          f"{o_bf16 / 1e6:.6g} MB) {'ok' if grow < o_bf16 else 'MISS'}",
          flush=True)
    check(grow < o_bf16, "an int8 step allocated a dequantized weight's "
          "worth of memory")
    dev = step_breakdown(L, engine, cfg, args, engine.k_pool, engine.v_pool,
                         wall / steps, smi_line, verify_rows=K,
                         row_tiles=verify)
    # int8's aim: a step's device time below bf16's (a reading, not a
    # gate: PERF.md §6 row 14 says what holds the 128-row products back)
    bf16_dev = report.get("_bf16_step_device_ms")
    below = dev is not None and bf16_dev is not None and dev < bf16_dev
    print(f"int8 (a): a ragged step's device ms {dev} against the bf16 "
          f"step's {bf16_dev} in this run: {'below' if below else 'MISS'} "
          f"[{smi_line}]", flush=True)
    del engine, captured
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the bucketed int8 engine
    beng = gw.build_engine(model, quantize="int8", ragged=False,
                           max_batch=4, max_seq=1024, page_size=16,
                           device="cuda")
    kernels = {"weight_only_linear": kwol.weight_only_linear,
               "paged_decode_attention": kpa.paged_decode_attention,
               "rms_norm": krn.rms_norm, "swiglu": ksw.swiglu}
    res_b, wall_b, launches, (decodes, prefills, ticks_b) = serve_burst(
        beng, prompts, max_new, kernels, "int8 bucketed request",
        lambda: (beng.decode_steps, sum(beng.prefill_calls.values()),
                 beng.ticks))
    fwd = decodes + prefills
    want = {"weight_only_linear": fwd * testing.int8_step_launches(L_),
            "paged_decode_attention": L_ * decodes,
            "rms_norm": (2 * L_ + 1) * fwd, "swiglu": 0}
    for name, n in launches.items():
        print(f"launches {name} (int8 bucketed serving): {n} (decode ticks "
              f"{decodes}, prefill calls {prefills} -> expected "
              f"{want[name]})", flush=True)
        check(n == want[name], f"{name} launched {n} times in int8 "
              f"bucketed serving, expected {want[name]}")
        if n:
            add_launches(report, name, "int8_bucketed_serving", n)
    ttfts = [res_b[i]["ttft_s"] for i in range(len(prompts))]
    n_tok = sum(len(res_b[i]["tokens"]) for i in range(len(prompts)))
    print(f"int8 (b) bucketed serve: ticks={ticks_b} decode_ticks={decodes} "
          f"prefill_calls={prefills} ttft_ms="
          f"{[round(1e3 * t, 3) for t in ttfts]} wall_s={wall_b:.6g} "
          f"tokens_per_s={n_tok / wall_b:.6g} [{smi_line}]", flush=True)

    # (c) verify rows bitwise decode rows through the int8 layers
    same, n = int8_verify_bitwise(L, beng, cfg)
    print(f"int8 (c): {same}/{n} verify rows bitwise their decode rows "
          f"through {L_} int8 layers and the int8 lm head", flush=True)
    check(n == 20 and same == n, f"int8 verify rows: {same}/{n} bitwise")

    # (d) the bf16 engine over the dequantized weights
    with torch.no_grad():
        model.load_state_dict(serving._dequant_state(beng.state, beng.dtype))
    del beng
    gc.collect()
    torch.cuda.empty_cache()
    ref = gw.build_engine(model, **SLO_KNOBS)
    res_d, wall_d, _, _ = serve_burst(ref, prompts, max_new, {},
                                      "dequantized bf16 request",
                                      lambda: (), in_order=True)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    for i, p in enumerate(prompts):
        a, b = res_a[i]["tokens"], res_d[i]["tokens"]
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        if first is None:
            print(f"int8 (d) stream {i}: tokens equal to the dequantized "
                  f"bf16 engine's ({len(a)})", flush=True)
            continue
        with torch.no_grad():
            ids = torch.tensor([p + b[:first]], dtype=torch.int32,
                               device="cuda")
            gap = testing.top2_gap(model(ids)[0, -1])
        ok = gap <= testing.INT8_GAP_LIMIT
        print(f"int8 (d) stream {i}: first difference at token {first} "
              f"(int8 {a[first]}, bf16 {b[first]}), the bf16 model's top-2 "
              f"gap there {gap:.6g} (limit {testing.INT8_GAP_LIMIT:g}) "
              f"{'ok' if ok else 'MISS'}", flush=True)
        check(ok, f"int8 stream {i} parts from the dequantized bf16 engine "
              f"at a top-2 gap of {gap:.6g}")

    # (e) the incubate functions at llama_7b width
    incubate_card_check(report, smi_line)


def int8_verify_bitwise(L, engine, cfg):
    """`testing.verify_bitwise` through the int8 model: the verify case
    of `RAGGED_ROWS` (4 entries of 5 rows at 22/105/305/705 keys) as one
    ragged step over `engine`'s int8 weights and pools, every row's
    logits (the int8 lm head at 128 rows) against the same row sent as
    a decode row."""
    import torch

    from paddle_tpu_torch import testing

    rows = RAGGED_ROWS["verify"]
    T, page = 128, engine.page
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (T,), generator=gen,
                         device="cuda", dtype=torch.int32)
    pt = torch.zeros((len(rows), engine.ppmax), dtype=torch.int32,
                     device="cuda")
    nxt = 1
    for s_, (_, _, kl) in enumerate(rows):
        n = -(-kl // page)
        pt[s_, :n] = torch.arange(nxt, nxt + n, dtype=torch.int32)
        nxt += n
    meta = [torch.tensor([r[i] for r in rows], dtype=torch.int32,
                         device="cuda") for i in range(3)]
    state, wls = engine.state, engine._wls
    norm = state["model.norm.weight"]

    def fn(toks, kp, vp, q_start, q_len, kv_len, pt, row_tiles=None):
        pos = torch.zeros(T, dtype=torch.int32)
        pids = torch.zeros(T, dtype=torch.int32)
        offs = torch.zeros(T, dtype=torch.int32)
        qs, ql, kl = (t.tolist() for t in (q_start, q_len, kv_len))
        ptc = pt.cpu()
        for s_ in range(len(qs)):
            for j in range(ql[s_]):
                p_ = kl[s_] - ql[s_] + j
                pos[qs[s_] + j] = p_
                pids[qs[s_] + j] = ptc[s_, p_ // page]
                offs[qs[s_] + j] = p_ % page
        pos, pids, offs = (t.cuda() for t in (pos, pids, offs))
        with torch.no_grad():
            h = state["model.embed_tokens"][toks.long()]
            for li, wl in enumerate(wls):
                h = L._block_ragged(cfg, h, wl, kp[li], vp[li], pos, pids,
                                    offs, pt, q_start, q_len, kv_len,
                                    row_tiles)
            h = L._rms(h, norm, cfg.rms_norm_eps)
            return L._lm_head(state, h[:, None]).float()[:, 0]

    tiles = torch.ones(len(rows), dtype=torch.int32, device="cuda")
    return testing.verify_bitwise(fn, (toks, engine.k_pool, engine.v_pool,
                                       *meta, pt), row_tiles=tiles)


def incubate_card_check(report, smi_line):
    """Phase 6d (e): the incubate functions at llama_7b width, each on
    the kernel route against the plain route (`plain_routes`) within
    `testing.SURFACE_RTOL` of max |plain|, its kernels' launches exact,
    and its ms a call by CUDA events."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    from paddle_tpu_torch.quantization import comm

    g = torch.Generator(device="cuda").manual_seed(11)
    B, H, nh, d, inter = 4, 4096, 32, 128, 11008
    bf = torch.bfloat16
    lens = (17, 100, 300, 700)

    def rnd(*shape, scale=1.0, dtype=bf):
        return (scale * torch.randn(shape, generator=g,
                                    device="cuda")).to(dtype)

    counters = {"rms_norm": krn.rms_norm,
                "flash_attention_fwd": kfa.flash_attention_fwd,
                "flash_attention_seg_fwd": kfa.flash_attention_seg_fwd,
                "paged_decode_attention": kpa.paged_decode_attention,
                "weight_only_linear": kwol.weight_only_linear}
    cases = {}
    # fused_rms_norm: row 1 over [4, 128, 4096]
    x = rnd(B, 128, H)
    w = 1 + 0.1 * torch.randn((H,), generator=g, device="cuda")
    cases["fused_rms_norm"] = (lambda: IF.fused_rms_norm(x, w, epsilon=1e-5),
                               {"rms_norm": 1})
    # block_multihead_attention: row 13 over [pages, 32, 16, 128] pools
    pp = -(-(max(lens) + 1) // 16)
    kc, vc = rnd(B * pp + 1, nh, 16, d), rnd(B * pp + 1, nh, 16, d)
    bt = (1 + torch.arange(B * pp, device="cuda",
                           dtype=torch.int32)).reshape(B, pp)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(B, dtype=torch.int32, device="cuda")
    qkv = rnd(B, 3 * H)
    cases["block_multihead_attention"] = (
        lambda: IF.block_multihead_attention(
            qkv, kc, vc, zeros, sl, zeros + 1, block_tables=bt)[0],
        {"paged_decode_attention": 1})
    # masked_multihead_attention: row 13 over a [2, 4, 32, 1024, 128]
    # cache read in place, neox rotary
    cache = rnd(2, B, nh, 1024, d)
    cases["masked_multihead_attention"] = (
        lambda: IF.masked_multihead_attention(
            qkv, cache, sequence_lengths=sl, rotary_emb_dims=1,
            use_neox_rotary_style=True)[0],
        {"paged_decode_attention": 1})
    # variable_length_memory_efficient_attention: row 10's segment
    # forward over [4, 32, 512, 128] with per-sequence lengths
    q4, k4, v4 = rnd(B, nh, 512, d), rnd(B, nh, 512, d), rnd(B, nh, 512, d)
    vl = torch.tensor((512, 300, 100, 17), dtype=torch.int32, device="cuda")
    cases["variable_length_memory_efficient_attention"] = (
        lambda: IF.variable_length_memory_efficient_attention(
            q4, k4, v4, vl, vl),
        {"flash_attention_seg_fwd": 1})
    # fused_multi_head_attention: row 10's forward, eval, pre-LN
    xa = rnd(B, 512, H)
    qkvw, lw = rnd(3, nh, d, H, scale=0.02), rnd(H, H, scale=0.02)
    ones = torch.ones(H, device="cuda", dtype=bf)
    cases["fused_multi_head_attention"] = (
        lambda: IF.fused_multi_head_attention(
            xa, qkvw, lw, pre_layer_norm=True, pre_ln_scale=ones,
            training=False),
        {"flash_attention_fwd": 1})
    # weight_only_linear: row 14, incubate's float order
    wq, ws = IF.weight_quantize(0.02 * torch.randn((H, 3 * H), generator=g,
                                                   device="cuda"))
    xw = rnd(B, H)
    cases["weight_only_linear"] = (
        lambda: IF.weight_only_linear(xw, wq, weight_scale=ws),
        {"weight_only_linear": 1})
    # fused_multi_transformer: 2 int8 layers, swiglu, rotary, caches;
    # a prefill of 128 tokens, then one decode step
    Lf, S = 2, 128

    def pair(shape_kn, stored):
        wf = 0.02 * torch.randn(shape_kn, generator=g, device="cuda")
        q, s = comm.channelwise_absmax_int8(wf, axis=0)
        return (q.reshape(stored), s.reshape((1,) + tuple(stored[1:])))

    fw = dict(
        ln_scales=[ones] * Lf, ln_biases=None,
        qkv_weights=[pair((H, 3 * H), (H, 3, nh, d)) for _ in range(Lf)],
        qkv_biases=None,
        linear_weights=[pair((H, H), (H, H)) for _ in range(Lf)],
        linear_biases=None, ffn_ln_scales=[ones] * Lf, ffn_ln_biases=None,
        ffn1_weights=[pair((H, 2 * inter), (H, 2 * inter))
                      for _ in range(Lf)],
        ffn1_biases=None,
        ffn2_weights=[pair((inter, H), (inter, H)) for _ in range(Lf)],
        ffn2_biases=None)
    xf = rnd(B, S + 1, H)
    caches = [torch.zeros((2, B, nh, 256, d), device="cuda", dtype=bf)
              for _ in range(Lf)]

    def fmt():
        kw = dict(rotary_emb_dims=1, activation="swiglu", trans_qkvw=False)
        out, _ = IF.fused_multi_transformer(xf[:, :S], **fw,
                                            cache_kvs=caches, **kw)
        dec, _ = IF.fused_multi_transformer(
            xf[:, S:], **fw, cache_kvs=caches, time_step=S, **kw)
        return torch.cat([out, dec], dim=1)

    cases["fused_multi_transformer"] = (fmt, {"weight_only_linear": 8 * Lf})

    for name, (fn, want) in cases.items():
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            out = fn()
            torch.cuda.synchronize()
            got = {k: c.launches for k, c in counters.items() if c.launches}
            with plain_routes():
                ref = fn()
            torch.cuda.synchronize()
        err = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max().clamp_min(1e-30)).item()
        ok = (err <= testing.SURFACE_RTOL and got == want
              and bool(torch.isfinite(out).all()))
        with torch.no_grad():
            ms = time_ms(fn, 10)
            with plain_routes():
                plain_ms = time_ms(fn, 3)
        print(f"incubate (e) {name}: kernel vs plain route max|diff|/max|"
              f"plain|={err:.6g} (limit {testing.SURFACE_RTOL:g}) launches "
              f"{got} (expected {want}) ms={ms:.6g} plain_ms={plain_ms:.6g} "
              f"{'ok' if ok else 'MISS'} [{smi_line}]", flush=True)
        check(ok, f"incubate {name}: kernel route {err:.6g} off its plain "
              f"route or launches {got} != {want}")
        for k, n in want.items():
            add_launches(report, k, f"incubate_{name}", n)


class HookClock:
    """Host seconds spent inside the request-trace and device-event calls
    (`install` wraps them; nested calls count once, to the outermost),
    in all and by the wrapped call's name."""

    def __init__(self):
        self.seconds, self.depth, self.saved = 0.0, 0, []
        self.by_name = {}

    def wrap(self, fn, name):
        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t
                self.seconds += dt
                self.by_name[name] = self.by_name.get(name, 0.0) + dt
                self.depth -= 1
        return timed

    def install(self, eng):
        from paddle_tpu_torch.observability import device_events, reqtrace
        for owner, name in ((reqtrace.RequestTrace, "charge"),
                            (reqtrace.RequestTrace, "event"),
                            (reqtrace.RequestTrace, "finish"),
                            (reqtrace.RequestTrace, "preload"),
                            (reqtrace, "new_trace"),
                            (device_events.execution, "__enter__"),
                            (device_events.execution, "__exit__")):
            fn = getattr(owner, name)
            self.saved.append((owner, name, fn))
            setattr(owner, name, self.wrap(fn, f"{owner.__name__}.{name}"))
        for name in ("_trace_settle", "_trace_charge_tick"):
            setattr(eng, name, self.wrap(getattr(eng, name), name))

    def remove(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def traced_engine(model, armed, **knobs):
    """The default engine with observability armed (tracing and the
    device events on, as `serve` runs it), or FLAGS_request_trace=0 with
    observability off."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import gateway as gw
    obs.enable(armed)
    if armed:
        eng = gw.build_engine(model, **dict(SLO_KNOBS, **knobs))
        check(eng._rtrace and eng._slo and eng._spec, "the default engine "
              "did not arm request tracing, the SLO layer and speculation")
        return eng
    fcore.set_flags({"FLAGS_request_trace": False})
    try:
        eng = gw.build_engine(model, **dict(SLO_KNOBS, **knobs))
    finally:
        fcore.set_flags({"FLAGS_request_trace": True})
    check(not eng._rtrace, "FLAGS_request_trace=0 armed request tracing")
    return eng


def trace_parity(report, model, prompts, max_new, smi_line):
    """(a) phase 4's burst armed and under FLAGS_request_trace=0, twice
    each (armed, off, off, armed): tokens and per-tick trace identical;
    step ms, tokens/s and the hooks' host ms a tick, each side's mean;
    then the same prompts driven tick by tick under torch.profiler, the
    synchronizing CUDA runtime calls counted on each side."""
    import torch

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.inference.serving import GenerationRequest
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa
    from paddle_tpu_torch.kernels import rms_norm as krn
    from paddle_tpu_torch.kernels import swiglu as ksw

    L_ = model.cfg.num_hidden_layers
    kernels = {"rms_norm": krn.rms_norm, "swiglu": ksw.swiglu,
               "ragged_paged_attention": krpa.ragged_paged_attention}

    def run(armed, what, path=None):
        eng = traced_engine(model, armed)
        trace, step_s, marks, clock = [], [], [], HookClock()
        real_step = eng.step

        def step():
            t = time.perf_counter()
            done = real_step()
            step_s.append(time.perf_counter() - t)
            trace.append((eng.last_packed_tokens, len(done),
                          eng.preemptions))
            return done

        eng.step = step
        if armed:
            clock.install(eng)

        def counters():
            marks.append((len(step_s), clock.seconds))
            return (eng.model_steps,)

        try:
            results, wall, launches, (steps,) = serve_burst(
                eng, prompts, max_new, kernels, what, counters,
                in_order=True)
        finally:
            clock.remove()
            obs.enable(False)
        (n0, s0), (n1, s1) = marks
        want = {"rms_norm": steps * (2 * L_ + 1), "swiglu": steps * L_,
                "ragged_paged_attention": steps * L_}
        for name, n in launches.items():
            print(f"launches {name} ({what}): {n} (steps {steps} -> "
                  f"expected {want[name]})", flush=True)
            check(n == want[name] and n > 0,
                  f"{name} launched {n} times in the {what}, expected "
                  f"{want[name]}")
            if path:
                add_launches(report, name, path, n)
        ticks = n1 - n0
        step_ms = 1e3 * sum(step_s[n0:n1]) / ticks
        hook_ms = 1e3 * (s1 - s0) / ticks
        n_tok = sum(len(results[i]["tokens"]) for i in range(len(prompts)))
        print(f"trace (a) {what}: ticks={ticks} step_ms={step_ms:.6g} "
              f"tokens_per_s={n_tok / wall:.6g} trace_hook_host_ms_per_tick="
              f"{hook_ms:.6g} [{smi_line}]", flush=True)
        if armed:
            # the whole run's (warm-up request included), by call
            n_all = len(step_s)
            print(f"trace (a) {what}: hook host ms a tick by call over all "
                  f"{n_all} ticks: " + ", ".join(
                      f"{k} {1e3 * v / n_all:.4g}" for k, v in sorted(
                          clock.by_name.items(), key=lambda kv: -kv[1])),
                  flush=True)
        del eng
        free_engine()
        return results, trace, step_ms, n_tok / wall, hook_ms

    runs = []
    for i, armed in enumerate((True, False, False, True)):
        what = (f"tracing {'armed' if armed else 'kill switch'} "
                f"run {i + 1}")
        runs.append((armed,) + run(armed, what, "traced_serving" if i == 0
                                   else None))
    res_on, tr_on = runs[0][1:3]
    for i, (armed, res, trace, *_) in enumerate(runs):
        same = [res_on[k]["tokens"] == res[k]["tokens"]
                for k in range(len(prompts))]
        side = "armed" if armed else "kill switch"
        print(f"trace (a) run {i + 1} ({side}): tokens of each stream == "
              f"run 1's: {same}; "
              f"per-tick trace == run 1's: {trace == tr_on} ({len(trace)} "
              f"ticks)", flush=True)
        check(all(same), f"run {i + 1}: tracing changed the tokens")
        check(trace == tr_on, f"run {i + 1}: tracing changed the per-tick "
              f"trace")

    def mean(k, armed):
        vals = [r[k] for r in runs if r[0] == armed]
        return sum(vals) / len(vals)

    print(f"trace (a) step_ms armed {mean(3, True):.6g} kill switch "
          f"{mean(3, False):.6g}; tokens_per_s armed {mean(4, True):.6g} "
          f"kill switch {mean(4, False):.6g}; trace_hook_host_ms_per_tick "
          f"{mean(5, True):.6g} (runs 1 and 4 against 2 and 3) "
          f"[{smi_line}]", flush=True)

    # the same prompts driven tick by tick on this thread, with no
    # gateway threads to take the GIL when a call releases it (a CUDA
    # event record does; so does every ctypes kernel launch)
    def direct(armed, i):
        eng = traced_engine(model, armed)
        clock, walls = HookClock(), []
        real_step = eng.step

        def step():
            t = time.perf_counter()
            done = real_step()
            walls.append(time.perf_counter() - t)
            return done

        eng.step = step
        if armed:
            clock.install(eng)
        reqs = [GenerationRequest(list(p), max_new_tokens=max_new)
                for p in prompts]
        try:
            ticks = drive(eng, reqs)
        finally:
            clock.remove()
            obs.enable(False)
        step_ms, hook_ms = 1e3 * sum(walls) / ticks, 1e3 * clock.seconds / ticks
        side = "armed" if armed else "kill switch"
        print(f"trace (a) direct drive run {i} ({side}): ticks={ticks} "
              f"step_ms={step_ms:.6g} trace_hook_host_ms_per_tick="
              f"{hook_ms:.6g}" + (" by call: " + ", ".join(
                  f"{k} {1e3 * v / ticks:.4g}" for k, v in sorted(
                      clock.by_name.items(), key=lambda kv: -kv[1]))
                  if armed else "") + f" [{smi_line}]", flush=True)
        out = [r.output for r in reqs]
        del eng
        free_engine()
        return step_ms, hook_ms, out

    drives = [(armed,) + direct(armed, i + 1)
              for i, armed in enumerate((True, False, False, True))]
    check(all(d[3] == drives[0][3] for d in drives),
          "the direct drives' tokens differ")

    def dmean(k, armed):
        vals = [d[k] for d in drives if d[0] == armed]
        return sum(vals) / len(vals)

    print(f"trace (a) direct drive step_ms armed {dmean(1, True):.6g} kill "
          f"switch {dmean(1, False):.6g}; trace_hook_host_ms_per_tick "
          f"{dmean(2, True):.6g} [{smi_line}]", flush=True)

    # the synchronizing runtime calls, the same ticks on both sides
    syncs = {}
    for armed in (True, False):
        eng = traced_engine(model, armed)
        reqs = [GenerationRequest(list(p), max_new_tokens=max_new)
                for p in prompts]
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                ticks = drive(eng, reqs)
        finally:
            obs.enable(False)
        check(all(r.status == "served" for r in reqs),
              "a profiled request was not served")
        events = prof.events()
        syncs[armed] = (testing.sync_calls(events), ticks,
                        [r.output for r in reqs])
        names = {}
        for e in events:
            if e.name in testing.SYNC_CALLS:
                names[e.name] = names.get(e.name, 0) + 1
        print(f"trace (a) {'armed' if armed else 'kill switch'}: "
              f"synchronizing calls by name {names}", flush=True)
        del eng, prof
        free_engine()
    (a_n, a_t, a_out), (o_n, o_t, o_out) = syncs[True], syncs[False]
    print(f"trace (a) synchronizing CUDA runtime calls: armed {a_n} in "
          f"{a_t} ticks ({a_n / a_t:.6g} a tick), kill switch {o_n} in "
          f"{o_t} ticks ({o_n / o_t:.6g} a tick); tokens equal "
          f"{a_out == o_out}", flush=True)
    check(a_t == o_t and a_out == o_out, "the profiled drives differ")
    check(a_n == o_n and a_n > 0, "the telemetry changed the count of "
          "synchronizing CUDA runtime calls")


def get_raw(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def trace_gateway(model, prompts, max_new, smi_line):
    """(b) phase 4's burst through the gateway, armed, one stream with a
    `traceparent`: an X-Request-Id on every stream, each /v1/trace
    served with its timeline and an exact ledger, 404 for an unknown id,
    /metrics with attribution exemplars, one xla.execute_seconds
    reading a ragged step within its tick's host wall; (d) with
    FLAGS_request_trace_sink set, each terminal JSONL record equal to the
    request's /v1/trace snapshot."""
    import shutil
    import tempfile

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference import gateway as gw
    from paddle_tpu_torch.observability import device_events
    from paddle_tpu_torch.observability import metrics as om

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    sink = os.path.join(tmp, "traces.jsonl")
    fcore.set_flags({"FLAGS_request_trace_sink": sink})
    eng = traced_engine(model, True)
    tap = testing.ObservationTap(device_events._H_EXECUTE)
    device_events._H_EXECUTE = tap
    ticks = []                     # (host wall, model steps in the tick)
    real_step = eng.step

    def step():
        n0, t = eng.model_steps, time.perf_counter()
        done = real_step()
        ticks.append((time.perf_counter() - t, eng.model_steps - n0))
        return done

    eng.step = step
    runner = gw.EngineRunner(eng)
    gateway = gw.ServingGateway(runner, port=0)
    port = gateway.start()
    tid = "c0ffee00" * 4
    try:
        warm = {}
        post_stream(port, [1, 2, 3, 4, 5], 2, warm, 0)
        check(warm[0]["end"] and warm[0]["end"][1]["status"] == "served",
              f"traced warm-up did not serve: {warm[0]['end']}")
        device_events.flush()
        om.reset()
        tap.seen.clear()
        ticks.clear()
        steps0, ticks0 = eng.model_steps, eng.ticks
        threads, res = queued_posts(
            runner, port, [(p, max_new, None) for p in prompts], "traced",
            headers={1: {"traceparent": f"00-{tid}-00f067aa0ba902b7-01"}})
        join_all(threads, "traced")
        gateway.drain(timeout=60)
        device_events.flush()
        steps, n_ticks = eng.model_steps - steps0, eng.ticks - ticks0
        docs = {}
        for i in range(len(prompts)):
            r = res[i]
            rid = r["request_id"]
            check(r["end"] is not None and r["end"][1]["status"] == "served"
                  and len(r["tokens"]) == max_new,
                  f"traced stream {i} ended {r['end']}")
            check(bool(rid) and r["end"][1].get("trace_id") == rid,
                  f"stream {i}: X-Request-Id {rid!r}, terminal frame "
                  f"{r['end'][1]}")
            status, body = get_raw(port, f"/v1/trace/{rid}")
            check(status == 200, f"/v1/trace/{rid} answered {status}")
            doc = json.loads(body)
            names = [e["ev"] for e in doc["events"]]
            gap = abs(sum(doc["buckets"].values()) - doc["wall"])
            print(f"trace (b) stream {i}: id {rid} status {doc['status']} "
                  f"events {names} decode_ticks {doc['decode_ticks']} "
                  f"buckets {json.dumps(doc['buckets'])} wall "
                  f"{doc['wall']:.6g} |sum - wall| {gap:.3g}", flush=True)
            check(doc["status"] == "served" and doc["terminal"],
                  f"trace {rid} status {doc['status']}")
            for must in ("arrival", "admitted", "prefill_chunk",
                         "first_token", "finished"):
                check(must in names, f"trace {rid} lacks {must}: {names}")
            check(gap <= 1e-6, f"trace {rid}: buckets sum off the wall by "
                  f"{gap}")
            docs[rid] = doc
        check(res[1]["request_id"] == tid, f"the traceparent id {tid} came "
              f"back as {res[1]['request_id']}")
        status, _ = get_raw(port, "/v1/trace/" + "0" * 32)
        check(status == 404, f"an unknown trace id answered {status}")
        status, body = get_raw(port, "/metrics")
        text = body.decode()
        attr = [ln for ln in text.splitlines()
                if ln.startswith("serving_attribution_seconds_bucket")]
        exemplars = [ln for ln in attr if '# {trace_id="' in ln]
        count = [ln for ln in text.splitlines() if ln.startswith(
            'xla_execute_seconds_count{executable="serving.ragged_step"}')]
        print(f"trace (b) /metrics: HTTP {status}, {len(text)} bytes, "
              f"{len(attr)} attribution bucket lines, {len(exemplars)} with "
              f"an exemplar; {count}; traceparent id kept; unknown id 404",
              flush=True)
        check(status == 200 and exemplars, "/metrics lacks attribution "
              "exemplars")
        readings = [v for tag, v in tap.seen if tag == "serving.ragged_step"]
        walls = [w for w, n in ticks if n]
        print(f"trace (b) xla.execute_seconds serving.ragged_step: "
              f"{len(readings)} readings for {steps} steps in {n_ticks} "
              f"ticks; ms min {1e3 * min(readings):.6g} mean "
              f"{1e3 * sum(readings) / len(readings):.6g} max "
              f"{1e3 * max(readings):.6g}; host ms a tick mean "
              f"{1e3 * sum(walls) / len(walls):.6g} [{smi_line}]",
              flush=True)
        check(len(readings) == steps == n_ticks and count
              and count[0].endswith(f" {steps}"),
              f"{len(readings)} execute readings for {steps} steps and "
              f"{n_ticks} ticks ({count})")
        check(all(n == 1 for _, n in ticks), "a tick ran no step or two")
        check(all(0 < v <= w for v, w in zip(readings, walls)),
              "an execute reading is not within its tick's host wall")
        # (d) the sink's terminal records against /v1/trace
        with open(sink) as f:
            terminal = {r["trace_id"]: r for r in map(json.loads, f)
                        if r["ev"] == "terminal"}
        keys = ("status", "wall", "buckets", "decode_ticks", "events")
        same = [all(terminal[rid][k] == docs[rid][k] for k in keys)
                for rid in docs]
        print(f"trace (d) FLAGS_request_trace_sink: {len(terminal)} terminal "
              f"records; each stream's == its /v1/trace snapshot: {same}",
              flush=True)
        check(all(same), "a sink record differs from /v1/trace")
    finally:
        device_events._H_EXECUTE = tap.inner
        gateway.drain(timeout=60)
        gateway.stop()
        fcore.set_flags({"FLAGS_request_trace_sink": ""})
        shutil.rmtree(tmp, ignore_errors=True)
        obs.enable(False)
        om.reset()
        del eng
        free_engine()


def trace_flight_recorder(model, smi_line):
    """(c) FLAGS_flight_recorder with a tick watchdog and one tick delayed
    three timeouts: the dump names the watchdog's section and its open
    span, and every request is still served."""
    import shutil
    import tempfile

    import numpy as np

    from paddle_tpu_torch.framework import core as fcore
    from paddle_tpu_torch.inference.serving import GenerationRequest

    timeout = 0.5
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    path = os.path.join(tmp, "flight.jsonl")
    rng = np.random.RandomState(41)
    reqs = [GenerationRequest(rng.randint(1, model.cfg.vocab_size,
                                          20).tolist(), max_new_tokens=8)
            for _ in range(3)]
    fcore.set_flags({"FLAGS_flight_recorder": path,
                     "FLAGS_fault_inject":
                     f"serving.tick:delay:{3 * timeout}@4"})
    try:
        eng = traced_engine(model, True, max_batch=3,
                            tick_timeout_s=timeout)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            drive(eng, reqs)
        fired = eng._wd.timeouts
        eng._wd.shutdown()
    finally:
        fcore.set_flags({"FLAGS_fault_inject": "",
                         "FLAGS_flight_recorder": ""})
        from paddle_tpu_torch import observability as obs
        obs.enable(False)
    with open(path) as f:
        dumps = [r for r in map(json.loads, f) if r["ev"] == "dump"]
    shutil.rmtree(tmp, ignore_errors=True)
    open_spans = [s["name"] for d in dumps for s in d["open_spans"]]
    print(f"trace (c) FLAGS_flight_recorder, tick_timeout_s={timeout}, "
          f"serving.tick:delay:{3 * timeout}@4: watchdog fired {fired}; "
          f"dumps {[d['reason'] for d in dumps]}; open spans {open_spans}; "
          f"statuses {[r.status for r in reqs]}", flush=True)
    check(fired >= 1 and dumps
          and dumps[0]["reason"].startswith("watchdog:serving.tick")
          and "watchdog.serving.tick" in open_spans,
          "the watchdog's flight dump is missing or does not name the "
          "stuck tick")
    check(all(r.status == "served" for r in reqs),
          "a request was not served across the delayed tick")
    del eng
    free_engine()


# device-kernel name fragments -> the group a step's time is charged to
_KERNEL_GROUPS = (("w8a16_kernel", "weight_only_linear"),
                  ("rms_norm_kernel", "rms_norm"), ("FwdEpi", "swiglu"),
                  ("swiglu_", "swiglu"),
                  ("ragged_paged_attention_kernel", "ragged_paged_attention"),
                  ("gemm", "gemm"), ("nvjet", "gemm"), ("xmma", "gemm"),
                  ("cutlass", "gemm"))


def step_breakdown(L, engine, cfg, args, kp, vp, wall_per_step_s, smi_line,
                   **step_kw):
    """Where one serving step's time goes: the captured step (with the
    speculative step's `step_kw`) through the kernel route and the plain
    route timed with CUDA events, then three kernel-route steps traced by
    torch.profiler, device time summed by kernel group; busy share =
    device time per step over the step's event time. Re-running the step
    rewrites the same pool slots. Returns the device ms a step (None when
    the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        L._ragged_step_paged(engine.state, cfg, args[0], args[1], kp, vp,
                             *args[2:], wls=engine._wls, **step_kw)

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
        return None
    parts = " ".join(f"{g}={ms:.6g}" for g, ms in groups.items())
    print(f"step profile (device ms per step): {parts} total={busy:.6g} "
          f"busy_share={busy / step_ms:.4f} [{smi_line}]", flush=True)
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    print("step profile, largest other kernels (ms per step): "
          + "; ".join(f"{k[:60]}={ms:.4g}" for k, ms in top), flush=True)
    return busy


# the generate decode step: the paged decode kernel, then the serving
# groups
_DECODE_GROUPS = (("paged_decode_kernel", "paged_decode_attention"),
                  *_KERNEL_GROUPS)


# training: device-kernel name fragments -> group, first match wins
# (the SwiGLU kernels' names carry their epilogue: FwdEpi for the
# forward, DguEpi and StoreEpi for the backward's two launches)
_TRAIN_GROUPS = (("ce_fwd_kernel", "fused_ce"), ("ce_bwd_kernel", "fused_ce"),
                 ("flash_fwd_", "flash_fwd"),
                 ("flash_bwd_", "flash_bwd"), ("flash_delta_", "flash_bwd"),
                 ("FwdEpi", "swiglu_fwd"),
                 ("DguEpi", "swiglu_bwd"), ("StoreEpi", "swiglu_bwd"),
                 ("gemm_simt_kernel", "swiglu_bwd"),
                 ("rms_norm_kernel", "norms"),
                 ("gemm", "cublas_gemm"), ("nvjet", "cublas_gemm"),
                 ("xmma", "cublas_gemm"), ("cutlass", "cublas_gemm"),
                 ("SoftMax", "cross_entropy"), ("softmax", "cross_entropy"),
                 ("gather", "cross_entropy"), ("scatter", "cross_entropy"))


def _device_ms(prof, groups, default):
    """Device ms of one traced region, summed by kernel group; kernels no
    fragment matches go to `default`. Returns (sums, {unmatched: ms})."""
    from torch.autograd import DeviceType
    sums, others = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3
        group = next((g for frag, g in groups if frag in e.key), None)
        if group is None:
            group = default
            others[e.key] = others.get(e.key, 0.0) + ms
        sums[group] = sums.get(group, 0.0) + ms
    return sums, others


def training_phase(report, smi_line):
    import dataclasses
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import llama as L

    cfg = L.llama_1b(dtype="bfloat16", use_recompute=False,
                     fuse_attention_qkv=True, fuse_mlp=True)
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, TRAIN_SEQ)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = L.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    opt = popt.AdamW(learning_rate=3e-4, parameters=model.parameters(),
                     weight_decay=0.1)
    step = TrainStep(model, opt, lambda ids, labels: model.loss(ids, labels))
    torch.cuda.synchronize()
    print(f"train: llama_1b bf16 built in {time.perf_counter() - t0:.3f} s, "
          f"{n_params} parameters, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}",
          flush=True)

    losses = [step(ids, ids) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    counters = testing.train_counters()
    for fn in counters.values():
        fn.launches = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    wall0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        losses.append(step(ids, ids))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [float(x) for x in losses]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    mean_ms = events[0].elapsed_time(events[-1]) / TRAIN_STEPS
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (mean_ms / 1e3)
    flops_per_token = (6 * n_params + 12 * cfg.num_hidden_layers
                       * cfg.hidden_size * TRAIN_SEQ)
    mfu = tok_s * flops_per_token / PEAK_FLOPS["bfloat16"]
    print(f"train: losses={[round(x, 6) for x in losses]} (first "
          f"{TRAIN_WARMUP} warm-up)", flush=True)
    print(f"train: step_ms={mean_ms:.6g} per step "
          f"{[round(x, 4) for x in step_ms]} wall_per_step_ms="
          f"{1e3 * wall / TRAIN_STEPS:.6g} tokens_per_s={tok_s:.6g} "
          f"mfu={mfu:.6g} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.6g} [{smi_line}]",
          flush=True)
    check(all(math.isfinite(x) for x in losses), "a training loss is not "
          "finite")
    check(losses[-1] < losses[0], "the loss did not fall over the steps")
    # FLAGS_use_fused_ce is off here: the loss takes the plain route
    per_step = dict(testing.train_launches(cfg.num_hidden_layers, "no remat"),
                    fused_cross_entropy=0, fused_cross_entropy_bwd=0)
    for name, n in launches.items():
        want = per_step[name] * TRAIN_STEPS
        print(f"launches {name} (training): {n} (steps {TRAIN_STEPS} -> "
              f"expected {want})", flush=True)
        check(n == want, f"{name} launched {n} times in training, expected "
                         f"{want}")
        add_launches(report, name, "training", n)

    # one more step, traced: TrainStep's calls in its order, the model's
    # forward and backward in one trace and the optimizer in another, so
    # AdamW's elementwise kernels are charged to it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_fb:
        loss = model.loss(ids, ids)
        loss.backward()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_opt:
        opt.step()
        opt.clear_grad(set_to_zero=False)
        torch.cuda.synchronize()
    groups, others = _device_ms(prof_fb, _TRAIN_GROUPS, "other")
    opt_groups, _ = _device_ms(prof_opt, (), "adamw")
    groups["adamw"] = opt_groups.get("adamw", 0.0)
    busy = sum(groups.values())
    if busy == 0.0:
        print("train profile: not measured (the profiler saw no device "
              "time)", flush=True)
    else:
        order = ("flash_fwd", "flash_bwd", "swiglu_fwd", "swiglu_bwd",
                 "norms", "cublas_gemm", "cross_entropy", "adamw", "other")
        parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}" for g in order)
        print(f"train profile (device ms, one step): {parts} "
              f"total={busy:.6g} busy_share={busy / mean_ms:.4f} "
              f"[{smi_line}]", flush=True)
        top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
        print("train profile, largest other kernels (ms): "
              + "; ".join(f"{k[:70]}={ms:.4g}" for k, ms in top), flush=True)
    del model, opt, step, loss, prof_fb, prof_opt
    torch.cuda.empty_cache()

    # route agreement: 2 layers at full width, one forward/backward on
    # each route from the same weights and batch
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model2 = L.LlamaForCausalLM(cfg2, device="cuda", generator=gen)

    def loss_and_grads():
        loss = model2.loss(ids, ids)
        loss.backward()
        grads = {n: p.grad.float() for n, p in model2.named_parameters()}
        for p in model2.parameters():
            p.grad = None
        return loss.item(), grads

    loss_k, grads_k = loss_and_grads()
    with plain_routes():
        loss_p, grads_p = loss_and_grads()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    rel = {n: ((grads_k[n] - grads_p[n]).norm()
               / grads_p[n].norm().clamp_min(1e-30)).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    ok = loss_err <= TRAIN_LOSS_RTOL and rel[worst] <= TRAIN_GRAD_RTOL
    print(f"train route agreement (2 layers, full width): loss kernel "
          f"{loss_k:.8g} plain {loss_p:.8g} rel_err={loss_err:.6g} (limit "
          f"{TRAIN_LOSS_RTOL:g}); grads max rel L2 {rel[worst]:.6g} at "
          f"{worst} (limit {TRAIN_GRAD_RTOL:g}) {'ok' if ok else 'MISS'}",
          flush=True)
    print("train route agreement, grad rel L2 by parameter: "
          + "; ".join(f"{n}={e:.4g}" for n, e in rel.items()), flush=True)
    check(ok, "the training kernel route disagrees with the plain route")
    del model2, grads_k, grads_p
    torch.cuda.empty_cache()
    return mean_ms


def train7b_phase(report, smi_line):
    """bench.py's 7B configuration on one card: llama_7b bf16, remat on
    under TrainStep's default policy, fused cross-entropy, batch 4 x
    2048; then the 2-layer remat and route checks."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import llama as L

    cfg = L.llama_7b(dtype="bfloat16", use_recompute=True,
                     fuse_attention_qkv=True, fuse_mlp=True)
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, TRAIN_SEQ)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    ptt.set_flags({"FLAGS_use_fused_ce": True})
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = L.LlamaForCausalLM(cfg, device="cuda", generator=gen)
        n_params = sum(p.numel() for p in model.parameters())
        opt = popt.AdamW(learning_rate=3e-4, parameters=model.parameters(),
                         weight_decay=0.1)
        torch.cuda.synchronize()
        print(f"train7b: llama_7b bf16 built in "
              f"{time.perf_counter() - t0:.3f} s, {n_params} parameters, "
              f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, use_recompute=True, "
              f"FLAGS_use_fused_ce=1", flush=True)
        step = TrainStep(model, opt, lambda i, l: model.loss(i, l))
        try:
            losses = [step(ids, ids) for _ in range(TRAIN7B_WARMUP)]
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            raise SmokeFailure(
                f"llama_7b under remat_policy=save_matmul_outputs ran out of "
                f"memory at batch {TRAIN_BATCH} x {TRAIN_SEQ}: peak_mem_gb="
                f"{torch.cuda.max_memory_allocated() / 1e9:.6g}") from e
        counters = testing.train_counters()
        for fn in counters.values():
            fn.launches = 0
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(TRAIN7B_STEPS + 1)]
        events[0].record()
        for i in range(TRAIN7B_STEPS):
            losses.append(step(ids, ids))
            events[i + 1].record()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        losses = [float(x) for x in losses]
        step_ms = [events[i].elapsed_time(events[i + 1])
                   for i in range(TRAIN7B_STEPS)]
        mean_ms = events[0].elapsed_time(events[-1]) / TRAIN7B_STEPS
        tok_s = TRAIN_BATCH * TRAIN_SEQ / (mean_ms / 1e3)
        flops_per_token = (6 * n_params + 12 * cfg.num_hidden_layers
                           * cfg.hidden_size * TRAIN_SEQ)
        mfu = tok_s * flops_per_token / PEAK_FLOPS["bfloat16"]
        peak = torch.cuda.max_memory_allocated()
        print(f"train7b: losses={[round(x, 6) for x in losses]} (first "
              f"{TRAIN7B_WARMUP} warm-up)", flush=True)
        print(f"train7b: remat_policy=save_matmul_outputs step_ms="
              f"{mean_ms:.6g} per step {[round(x, 4) for x in step_ms]} "
              f"tokens_per_s={tok_s:.6g} mfu={mfu:.6g} (bench.py's count, "
              f"{flops_per_token * TRAIN_BATCH * TRAIN_SEQ:.6g} FLOP a "
              f"step; recompute not counted) peak_mem_gb={peak / 1e9:.6g} "
              f"[{smi_line}]", flush=True)
        check(all(math.isfinite(x) for x in losses),
              "a 7B training loss is not finite")
        check(losses[-1] < losses[0], "the 7B loss did not fall")
        want = testing.train_launches(cfg.num_hidden_layers,
                                      "save_matmul_outputs")
        for name, n in launches.items():
            print(f"launches {name} (7B training, save_matmul_outputs): {n} "
                  f"(steps {TRAIN7B_STEPS} -> expected "
                  f"{want[name] * TRAIN7B_STEPS})", flush=True)
            check(n == want[name] * TRAIN7B_STEPS,
                  f"{name} launched {n} times in 7B training, expected "
                  f"{want[name] * TRAIN7B_STEPS}")
            add_launches(report, name, "training_7b", n)
        plain_syncs = step_syncs(lambda: step(ids, ids))
        torch.cuda.synchronize()

        # one more step, traced as the llama_1b phase traces its own
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_fb:
            with core.remat_policy_guard(step._remat_policy):
                loss = model.loss(ids, ids)
                loss.backward()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_opt:
            opt.step()
            opt.clear_grad(set_to_zero=False)
            torch.cuda.synchronize()
        groups, others = _device_ms(prof_fb, _TRAIN_GROUPS, "other")
        opt_groups, _ = _device_ms(prof_opt, (), "adamw")
        groups["adamw"] = opt_groups.get("adamw", 0.0)
        busy = sum(groups.values())
        if busy == 0.0:
            print("train7b profile: not measured (the profiler saw no "
                  "device time)", flush=True)
        else:
            order = ("flash_fwd", "flash_bwd", "swiglu_fwd", "swiglu_bwd",
                     "norms", "cublas_gemm", "fused_ce", "cross_entropy",
                     "adamw", "other")
            parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}" for g in order)
            print(f"train7b profile (device ms, one step): {parts} "
                  f"total={busy:.6g} busy_share={busy / mean_ms:.4f} "
                  f"[{smi_line}]", flush=True)
            top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
            print("train7b profile, largest other kernels (ms): "
                  + "; ".join(f"{k[:70]}={ms:.4g}" for k, ms in top),
                  flush=True)
        # 9c (a) on the same model: the plain optimizer's state first
        # freed
        del opt, step, loss, prof_fb, prof_opt
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        recipe7b(report, model, ids, mean_ms, plain_syncs, smi_line)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        remat_check(cfg, ids)
    finally:
        ptt.set_flags({"FLAGS_use_fused_ce": False})


def remat_check(cfg, ids):
    """2 layers at full llama_7b width, fused cross-entropy: one forward
    and backward without remat, then under each remat policy from the
    same weights and batch; loss and every grad must be bitwise equal,
    and peak memory ordered nothing <= save_matmul_outputs < no remat.
    Then the kernel route against the plain route."""
    import dataclasses

    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.jit import resolve_remat_policy
    from paddle_tpu_torch.models import llama as L

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = L.LlamaForCausalLM(cfg2, device="cuda", generator=gen)
    counters = testing.train_counters()

    def loss_and_grads(use_recompute, policy):
        """(loss, grads, the step's peak memory above what was resident
        before it, launches)."""
        model.cfg.use_recompute = use_recompute
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        with core.remat_policy_guard(resolve_remat_policy(policy)):
            loss = model.loss(ids, ids)
            loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - resident
        grads = {n: p.grad for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return (loss.detach(), grads, peak,
                {n: fn.launches for n, fn in counters.items()})

    # each policy's grads are compared and dropped before the next run,
    # so every run starts from the same resident memory
    first = loss_and_grads(False, None)
    loss0, grads0 = first[:2]
    peaks = {}
    for name in ("no remat", None, "nothing", "save_matmul_outputs", "dots"):
        loss, grads, peaks[name], launches = (
            first if name == "no remat" else loss_and_grads(True, name))
        same = bool(torch.equal(loss, loss0)) and all(
            torch.equal(grads[n], grads0[n]) for n in grads0)
        want = testing.train_launches(2, "nothing" if name is None else name)
        print(f"remat check (2 layers, full width) {name}: loss "
              f"{loss.item():.8g} bitwise {'equal' if same else 'DIFFERS'} "
              f"step_peak_mem_gb={peaks[name] / 1e9:.6g} launches "
              f"{'exact' if launches == want else launches}", flush=True)
        check(same, f"remat policy {name}: loss or grads differ from the "
                    f"run without remat")
        check(launches == want, f"remat policy {name}: launches {launches}, "
                                f"expected {want}")
        del grads
    check(peaks["nothing"] <= peaks["save_matmul_outputs"]
          < peaks["no remat"], f"peak memory out of order: {peaks}")
    del first, grads0

    # the kernel route (remat, fused cross-entropy) against the plain route
    loss_k, grads_k, _, _ = loss_and_grads(True, "save_matmul_outputs")
    with plain_routes():
        loss_p, grads_p, _, _ = loss_and_grads(True, "save_matmul_outputs")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    rel = {n: ((grads_k[n].float() - grads_p[n].float()).norm()
               / grads_p[n].float().norm().clamp_min(1e-30)).item()
           for n in grads_p}
    worst = max(rel, key=rel.get)
    ok = loss_err <= TRAIN7B_LOSS_RTOL and rel[worst] <= TRAIN7B_GRAD_RTOL
    print(f"train7b route agreement (2 layers, full width, remat, fused "
          f"CE): loss kernel {loss_k.item():.8g} plain {loss_p.item():.8g} "
          f"rel_err={loss_err:.6g} (limit {TRAIN7B_LOSS_RTOL:g}); grads max "
          f"rel L2 {rel[worst]:.6g} at {worst} (limit "
          f"{TRAIN7B_GRAD_RTOL:g}) {'ok' if ok else 'MISS'}", flush=True)
    print("train7b route agreement, grad rel L2 by parameter: "
          + "; ".join(f"{n}={e:.4g}" for n, e in rel.items()), flush=True)
    check(ok, "the 7B training kernel route disagrees with the plain route")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


# BERT phase: bench.py's BERT configuration (bench.py:400-421) at
# inference, bert_base f32 in eval, batch 16 x 512, padded
BERT_BATCH, BERT_SEQ = 16, 512
BERT_WARMUP, BERT_ITERS = 2, 10
# the BERT forward's device kernels -> group, first match wins
_BERT_GROUPS = (("flash_fwd_", "segment_flash"), ("gemm", "cublas"),
                ("nvjet", "cublas"), ("xmma", "cublas"),
                ("cutlass", "cublas"))


def _expect_launches(counters, launches, want, what):
    """Every attention kernel's launch count is `want` (0 when absent)."""
    for name in counters:
        n = launches[name]
        print(f"launches {name} ({what}): {n} (expected "
              f"{want.get(name, 0)})", flush=True)
        check(n == want.get(name, 0), f"{name} launched {n} times in "
              f"{what}, expected {want.get(name, 0)}")


def bert_phase(report, smi_line):
    """`BertForMaskedLM` at bert_base in f32, eval, on a padded batch:
    ids from default_rng(0), lengths `testing.bert_lengths()` (one row of
    512), token types 0; forward ms by CUDA events over BERT_ITERS
    forwards after BERT_WARMUP; the segment flash forward launched 12
    times a forward and no other attention kernel; the kernel route
    against the plain route at valid rows; one forward traced."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.models import bert as TB

    cfg = TB.bert_base()
    B, S = BERT_BATCH, BERT_SEQ
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (B, S))).to("cuda")
    lengths = testing.bert_lengths(B, S)
    mask = (torch.arange(S, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None]).long()
    tt = torch.zeros_like(ids)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = TB.BertForMaskedLM(cfg, device="cuda", generator=gen).eval()
    torch.cuda.synchronize()
    print(f"bert: bert_base f32 built in {time.perf_counter() - t0:.3f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"batch {B} x {S}, lengths {lengths}", flush=True)
    counters = testing.attention_counters()
    with torch.no_grad():
        for _ in range(BERT_WARMUP):
            model(ids, tt, mask)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(BERT_ITERS):
            logits = model(ids, tt, mask)
        ev[1].record()
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    ms = ev[0].elapsed_time(ev[1]) / BERT_ITERS
    valid = mask.bool()
    n_valid = int(valid.sum())
    print(f"bert: forward_ms={ms:.6g} sequences_per_s={B * 1e3 / ms:.6g} "
          f"valid_tokens_per_s={n_valid * 1e3 / ms:.6g} (valid tokens "
          f"{n_valid} of {B * S}) peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 1e9:.6g} [{smi_line}]",
          flush=True)
    check(tuple(logits.shape) == (B, S, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"BERT logits {tuple(logits.shape)} {logits.dtype} not finite "
          f"[B, S, vocab] f32")
    L = cfg.num_hidden_layers
    _expect_launches(counters, launches,
                     {"flash_attention_seg_fwd": L * BERT_ITERS},
                     f"BERT, {BERT_ITERS} forwards")
    add_launches(report, "flash_attention_seg_fwd", "bert",
                 launches["flash_attention_seg_fwd"])
    del logits

    # the kernel route against the plain route, valid rows
    with torch.no_grad():
        seq_k, pooled_k = model.bert(ids, tt, mask)
        lg_k = model(ids, tt, mask)
        torch.cuda.synchronize()
        with plain_routes():
            seq_p, pooled_p = model.bert(ids, tt, mask)
            lg_p = model(ids, tt, mask)
        torch.cuda.synchronize()
    ok = True
    for what, a, b, lim, mlim in (
            ("sequence output", seq_k[valid], seq_p[valid],
             testing.BERT_SEQ_ATOL, testing.BERT_SEQ_MEAN_ATOL),
            ("logits", lg_k[valid], lg_p[valid], testing.BERT_LOGIT_ATOL,
             testing.BERT_LOGIT_MEAN_ATOL),
            ("pooled output", pooled_k, pooled_p, testing.BERT_SEQ_ATOL,
             testing.BERT_SEQ_MEAN_ATOL)):
        diff = (a - b).abs()
        err, mean = diff.max().item(), diff.mean().item()
        good = err <= lim and mean <= mlim
        ok = ok and good
        print(f"bert route agreement, {what} at valid rows: max_abs_err="
              f"{err:.6g} (limit {lim:g}) mean_abs_err={mean:.6g} (limit "
              f"{mlim:g}) max|plain|={b.abs().max().item():.6g} "
              f"{'ok' if good else 'MISS'}", flush=True)
    check(ok, "the BERT kernel route disagrees with the plain route")
    del seq_k, seq_p, lg_k, lg_p, pooled_k, pooled_p

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(ids, tt, mask)
            torch.cuda.synchronize()
    groups, others = _device_ms(prof, _BERT_GROUPS, "plain_torch")
    busy = sum(groups.values())
    if busy == 0.0:
        print("bert profile: not measured (the profiler saw no device "
              "time)", flush=True)
    else:
        parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}"
                         for g in ("segment_flash", "cublas", "plain_torch"))
        print(f"bert profile (device ms, one forward): {parts} total="
              f"{busy:.6g} busy_share={busy / ms:.4f} [{smi_line}]",
              flush=True)
        top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
        print("bert profile, largest plain torch kernels (ms): "
              + "; ".join(f"{k[:60]}={v:.4g}" for k, v in top), flush=True)
    del model, prof
    torch.cuda.empty_cache()


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


# ------------------------------------------------------ encoder training

# bench.py's encoder configurations (bench.py:399-421, 462): batch 16 x
# 512 of default_rng(0) ids, `model.loss(ids, ids)`, AdamW(1e-4, weight
# decay 0.01) through TrainStep, dropout armed (train mode, 0.1)
ENC_BATCH, ENC_SEQ = 16, 512
ENC_WARMUP, ENC_STEPS = 2, 5
# the encoder step's device kernels -> group, first match wins
_ENC_GROUPS = (("flash_fwd_", "flash_fwd"), ("flash_bwd_", "flash_bwd"),
               ("flash_delta_", "flash_bwd"), ("gemm", "cublas"),
               ("nvjet", "cublas"), ("xmma", "cublas"),
               ("cutlass", "cublas"))


def encoder_train_phase(report, smi_line):
    """bench.py's two encoder training configurations on the card,
    dropout armed: (a) ERNIE pretraining, (b) ERNIE's kernel route
    against its plain route, (c) BERT masked-LM fine-tuning on the dense
    probs-dropout route, (d) BERT with a padding mask and probs dropout
    0 on the segment kernels against the plain route, (e) the dropout
    masks on the card. The module docstring lists what each holds."""
    t0 = time.perf_counter()
    model, masks = encoder_train_run(report, "ernie", smi_line)
    del model
    encoder_route_check(report, "ernie", smi_line)
    model, _ = encoder_train_run(report, "bert", smi_line)
    del model
    encoder_route_check(report, "bert_mask", smi_line)
    dropout_card_check(masks, smi_line)
    print(f"encoder training phase: wall {time.perf_counter() - t0:.3f} s",
          flush=True)


def _encoder(which, device="cuda", seed=0, **kw):
    """(config, model) of bench.py's `which` encoder at full width, built
    on the card from a seeded generator; kw replaces config fields."""
    import dataclasses

    import torch

    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import ernie as TE
    gen = torch.Generator(device=device).manual_seed(seed)
    if which == "ernie":
        cfg = dataclasses.replace(TE.ernie_base(), **kw)
        return cfg, TE.ErnieForPretraining(cfg, device=device, generator=gen)
    cfg = dataclasses.replace(TB.bert_base(), **kw)
    return cfg, TB.BertForMaskedLM(cfg, device=device, generator=gen)


def encoder_train_run(report, which, smi_line):
    """(a) / (c): `which` ("ernie" or "bert") at its base config, f32,
    ENC_BATCH x ENC_SEQ, through TrainStep with dropout armed:
    ENC_WARMUP, then ENC_STEPS timed steps (CUDA events and wall), tokens
    /s, MFU by bench.py's count over the bf16 peak and its share of the
    f32 rate, peak memory; the attention kernels' launches exact
    (`testing.encoder_launches`: ERNIE's one-length flash kernels 12 a
    step each, BERT's dense route none); one more step traced, its
    device time by group, ERNIE's flash launches held to their 3xTF32
    cores. Two more steps record their dropout masks (returned): each
    keep share binomial, the second step's masks all new."""
    import math

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.functional import common as fcommon

    B, S = ENC_BATCH, ENC_SEQ
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model = _encoder(which)
    model.train()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to("cuda")
    n_params = sum(p.numel() for p in model.parameters())
    opt = popt.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.01)
    step = TrainStep(model, opt, lambda i, l: model.loss(i, l))
    L = cfg.num_hidden_layers
    route = "flash" if which == "ernie" else "dense"
    name = f"{which}_train"
    drop = (f"hidden {cfg.hidden_dropout_prob}" if which == "ernie" else
            f"hidden {cfg.hidden_dropout_prob}, probs "
            f"{cfg.attention_probs_dropout_prob}")
    torch.cuda.synchronize()
    print(f"{name}: {which}_base f32 built in {time.perf_counter() - t0:.3f}"
          f" s, {n_params} parameters, batch {B} x {S}, dropout {drop}, "
          f"attention route {route}", flush=True)

    losses = [step(ids, ids) for _ in range(ENC_WARMUP)]
    torch.cuda.synchronize()
    counters = testing.encoder_counters()
    for fn in counters.values():
        fn.launches = 0
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(ENC_STEPS + 1)]
    wall0 = time.perf_counter()
    events[0].record()
    for i in range(ENC_STEPS):
        losses.append(step(ids, ids))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = {n: fn.launches for n, fn in counters.items()}
    losses = [float(x) for x in losses]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(ENC_STEPS)]
    mean_ms = events[0].elapsed_time(events[-1]) / ENC_STEPS
    tokens = B * S
    tok_s = tokens / (mean_ms / 1e3)
    flops = (6 * n_params + 12 * L * cfg.hidden_size * S) * tokens
    mfu = flops / (mean_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    f32_share = flops / (mean_ms / 1e3) / PEAK_FLOPS["float32"]
    print(f"{name}: losses={[round(x, 6) for x in losses]} (first "
          f"{ENC_WARMUP} warm-up)", flush=True)
    print(f"{name}: step_ms={mean_ms:.6g} per step "
          f"{[round(x, 4) for x in step_ms]} wall_per_step_ms="
          f"{1e3 * wall / ENC_STEPS:.6g} tokens_per_s={tok_s:.6g} "
          f"mfu={mfu:.6g} (bench.py's count {flops:.6g} FLOP a step over "
          f"989 TFLOP/s) f32_rate_share={f32_share:.6g} (over 67 TFLOP/s) "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.6g} "
          f"[{smi_line}]", flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"a {name} loss is not finite")
    want = testing.encoder_launches(L, ENC_STEPS, route)
    _expect_launches(counters, launches, want,
                     f"{name}, {ENC_STEPS} steps")
    for n in want:
        add_launches(report, n, name, launches[n])

    # one more step, traced: the forward and backward in one trace, the
    # optimizer in another, so AdamW's elementwise kernels are its own
    flash = route == "flash"
    prof_fb = device_trace(
        lambda: model.loss(ids, ids).backward(),
        (lambda p: {"forward", "dkv", "dq", "delta"}
         <= set(flash_routes_of(p)[0])) if flash else None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_opt:
        opt.step()
        opt.clear_grad(set_to_zero=False)
        torch.cuda.synchronize()
    if flash:
        got, names = flash_routes_of(prof_fb)
        hold_routes(f"{name} step", "[flash, f32]", got, names,
                    expected_flash_routes(B, S, cfg.num_attention_heads,
                                          cfg.num_attention_heads,
                                          cfg.head_dim, False,
                                          torch.float32))
    groups, others = _device_ms(prof_fb, _ENC_GROUPS, "plain_torch")
    opt_groups, _ = _device_ms(prof_opt, (), "adamw")
    groups["adamw"] = opt_groups.get("adamw", 0.0)
    busy = sum(groups.values())
    if busy == 0.0:
        print(f"{name} profile: not measured (the profiler saw no device "
              f"time)", flush=True)
    else:
        parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}" for g in
                         ("cublas", "flash_fwd", "flash_bwd", "adamw",
                          "plain_torch"))
        print(f"{name} profile (device ms, one step): {parts} total="
              f"{busy:.6g} busy_share={busy / mean_ms:.4f} [{smi_line}]",
              flush=True)
        top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
        print(f"{name} profile, largest plain torch kernels (ms): "
              + "; ".join(f"{k[:70]}={ms:.4g}" for k, ms in top), flush=True)

    # (e), on this model's steps: two more steps, each mask recorded
    drawn = []
    real = fcommon._keep_mask

    def record(shape, p, generator, device):
        keep = real(shape, p, generator, device)
        drawn.append((p, keep))
        return keep

    fcommon._keep_mask = record
    try:
        more = [float(step(ids, ids)) for _ in range(2)]
    finally:
        fcommon._keep_mask = real
    n = len(drawn) // 2
    sig = [testing.keep_share_sigmas(keep, p) for p, keep in drawn]
    same = sum(torch.equal(a[1], b[1]) for a, b in zip(drawn[:n], drawn[n:]))
    print(f"{name} masks: {n} a step, keep share sigmas max "
          f"{max(abs(z) for z in sig):.4g} (limit {testing.DROPOUT_SIGMAS:g})"
          f", masks equal between two steps {same} of {n}, losses {more} "
          f"[{smi_line}]", flush=True)
    check(len(drawn) == 2 * n and n == 1 + (1 if flash else 3) * L,
          f"{name}: {len(drawn)} masks drawn in two steps")
    check(all(abs(z) <= testing.DROPOUT_SIGMAS for z in sig),
          f"{name}: a keep share is off the binomial")
    check(same == 0, f"{name}: two steps drew {same} equal masks")
    check(all(math.isfinite(x) for x in more), f"a {name} loss is not finite")
    del opt, step, prof_fb, prof_opt
    masks = drawn[0][1] if flash else None
    return model, masks


def encoder_route_check(report, which, smi_line):
    """(b) "ernie": a 2-layer full-width ernie_base, dropout 0, one
    train-mode forward and backward on the kernel route (the one-length
    f32 kernels, once a layer each) against `plain_routes()`. (d)
    "bert_mask": a 2-layer full-width bert_base, dropout 0, on the
    padded batch of `testing.bert_lengths()` with -100 labels on the
    padding (valid rows decide the loss and every grad): the f32 segment
    forward, delta, dkv and dq once a layer each and no other attention
    kernel, held to their 3xTF32 cores, against the plain route. |loss
    difference| / |loss| and each parameter's grad relative L2 within
    testing's limits."""
    import numpy as np
    import torch

    from paddle_tpu_torch import testing

    B, S = ENC_BATCH, ENC_SEQ
    ernie = which == "ernie"
    cfg, model = _encoder("ernie" if ernie else "bert", seed=1,
                          num_hidden_layers=2, **(
                              dict(hidden_dropout_prob=0.0) if ernie else
                              dict(hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)))
    model.train()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S))).to("cuda")
    if ernie:
        def fb():
            return model.loss(ids, ids)
        route, lrt, grt = ("flash", testing.ENCODER_LOSS_RTOL,
                           testing.ENCODER_GRAD_RTOL)
    else:
        lengths = testing.bert_lengths(B, S)
        mask = (torch.arange(S, device="cuda")[None, :]
                < torch.tensor(lengths, device="cuda")[:, None]).long()
        labels = torch.where(mask.bool(), ids, -100)

        def fb():
            return model.loss(ids, labels, attention_mask=mask)
        route, lrt, grt = ("segment", testing.BERT_TRAIN_LOSS_RTOL,
                           testing.BERT_TRAIN_GRAD_RTOL)

    def loss_and_grads():
        loss = fb()
        loss.backward()
        grads = {n: p.grad.float() for n, p in model.named_parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    counters = testing.encoder_counters()
    for fn in counters.values():
        fn.launches = 0
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in counters.items()}
    tag = ("ernie (b)" if ernie else "bert (d)") + " route agreement"
    want = testing.encoder_launches(2, 1, route)
    _expect_launches(counters, launches, want, f"{tag}, one pass")
    for n in want:
        add_launches(report, n, f"{which}_route_check", launches[n])
    if not ernie:
        got, names = traced_flash_routes(lambda: fb().backward(),
                                         ("forward", "dkv", "dq", "delta"))
        model.zero_grad(set_to_none=True)
        hold_routes(tag, "[segment, f32]", got, names,
                    expected_seg_routes(B, S, S, cfg.num_attention_heads,
                                        cfg.num_attention_heads,
                                        cfg.head_dim, False, torch.float32))
    with plain_routes():
        loss_p, grads_p = loss_and_grads()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(set(grads_k) == set(grads_p), f"{tag}: the routes' grads differ "
          f"in which parameters they reach")
    rel = {n: ((grads_k[n] - grads_p[n]).norm()
               / grads_p[n].norm().clamp_min(1e-30)).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    ok = loss_err <= lrt and rel[worst] <= grt
    print(f"{tag} (2 layers, full width, dropout 0): loss kernel "
          f"{loss_k:.8g} plain {loss_p:.8g} rel_err={loss_err:.6g} (limit "
          f"{lrt:g}); grads max rel L2 {rel[worst]:.6g} at {worst} (limit "
          f"{grt:g}) {'ok' if ok else 'MISS'} [{smi_line}]", flush=True)
    print(f"{tag}, grad rel L2 by parameter: "
          + "; ".join(f"{n}={e:.4g}" for n, e in rel.items()), flush=True)
    check(ok, f"{tag}: the kernel route disagrees with the plain route")
    del model, grads_k, grads_p
    torch.cuda.empty_cache()


def dropout_card_check(step_mask, smi_line):
    """(e) dropout on the card: a 16 x 512 x 768 keep mask's share within
    `testing.DROPOUT_SIGMAS` of the binomial (an explicit generator, and
    the first mask of an ERNIE training step, `step_mask`); the same
    generator seed gives equal masks, another seed others; the stream
    after `core.seed(s)` draws what a generator seeded s draws; p = 1
    zeroes, p = 0 and eval return the input."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import common as fcommon

    shape, p = (ENC_BATCH, ENC_SEQ, 768), 0.1

    def gen(s):
        return torch.Generator(device="cuda").manual_seed(s)

    a = fcommon._keep_mask(shape, p, gen(5), "cuda")
    b = fcommon._keep_mask(shape, p, gen(5), "cuda")
    c = fcommon._keep_mask(shape, p, gen(6), "cuda")
    z = testing.keep_share_sigmas(a, p)
    z_step = testing.keep_share_sigmas(step_mask, p)
    core.seed(21)
    x = torch.randn(shape, device="cuda", generator=gen(7))
    stream = F.dropout(x, p)
    seeded = F.dropout(x, p, generator=gen(21))
    checks = {
        "keep share (explicit generator)": abs(z) <= testing.DROPOUT_SIGMAS,
        "keep share (an ERNIE step's first mask)":
            abs(z_step) <= testing.DROPOUT_SIGMAS,
        "same seed, equal masks": torch.equal(a, b),
        "other seed, other mask": not torch.equal(a, c),
        "stream after seed(s) = generator seeded s":
            torch.equal(stream, seeded),
        "kept elements scaled by 1 / (1 - p)": bool(torch.allclose(
            stream[stream != 0], x[stream != 0] / (1 - p))),
        "p = 1 zeroes": not F.dropout(x, 1.0).any(),
        "p = 0 is the identity": F.dropout(x, 0.0) is x,
        "eval is the identity": F.dropout(x, p, training=False) is x,
    }
    print(f"dropout (e) on the card: keep share sigmas {z:.4g} (explicit "
          f"generator), {z_step:.4g} (an ERNIE step), limit "
          f"{testing.DROPOUT_SIGMAS:g}; " + "; ".join(
              f"{k} {'ok' if v else 'MISS'}" for k, v in checks.items())
          + f" [{smi_line}]", flush=True)
    check(all(checks.values()), "dropout on the card: "
          + ", ".join(k for k, v in checks.items() if not v))


# Phase 9c: the optimizer surface. (a) runs inside `train7b_phase`, on
# its model (`recipe7b`); (b) and (c) are `optimizer_phase`.
RECIPE_WARMUP, RECIPE_STEPS = 2, 3
O2_WARMUP, O2_STEPS = 2, 3
ZOO_STEPS, ZOO_BATCH, ZOO_SEQ = 3, 1, 128


def llama2_schedule(popt):
    """Touvron et al. 2023, "Llama 2", §2.2: 2000 warmup steps from 0 to
    3e-4, then cosine decay to 3e-5 (T_max 500000 steps)."""
    return popt.lr.LinearWarmup(
        popt.lr.CosineAnnealingDecay(3e-4, T_max=500000, eta_min=3e-5),
        warmup_steps=2000, start_lr=0.0, end_lr=3e-4)


def step_syncs(fn):
    """Synchronizing CUDA runtime calls (`testing.SYNC_CALLS`) fn makes:
    those of a torch.profiler window around it (no synchronize inside)
    less those of an empty window (the profiler's own)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import testing

    def window(f):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            f()
        return testing.sync_calls(prof.events())

    return window(fn) - window(lambda: None)


def _zero(counters):
    for fn in counters.values():
        fn.launches = 0


def _launches(counters):
    return {name: fn.launches for name, fn in counters.items()}


def _hold_launches(report, launches, want, passes, path, what):
    """Each kernel's launches in one run of a path against want[name] *
    passes; records them under the path."""
    for name, n in launches.items():
        expect = want[name] * passes
        print(f"launches {name} ({what}): {n} (expected {expect})",
              flush=True)
        check(n == expect, f"{name} launched {n} times in {what}, "
                           f"expected {expect}")
        add_launches(report, name, path, n)


def recipe7b(report, model, ids, plain_ms, plain_syncs, smi_line):
    """9c (a): the LLaMA 2 recipe on train7b_phase's llama_7b (remat
    under save_matmul_outputs, fused CE): AdamW(β2 0.95, eps 1e-5, wd
    0.1), ClipGradByGlobalNorm(1.0), `llama2_schedule`, stepped after
    each TrainStep. Bars: finite losses, the lr of each step equal to a
    fresh copy of the schedule's, exact launches."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.framework import core
    from paddle_tpu_torch.jit import TrainStep

    opt = popt.AdamW(learning_rate=llama2_schedule(popt), beta1=0.9,
                     beta2=0.95, epsilon=1e-5, weight_decay=0.1,
                     parameters=model.parameters(),
                     grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    expect = llama2_schedule(popt)
    step = TrainStep(model, opt, lambda i, l: model.loss(i, l))
    losses, lrs, want_lrs = [], [], []

    def one():
        losses.append(step(ids, ids))
        lrs.append(step.last_lr)
        want_lrs.append(expect())
        opt._lr.step()
        expect.step()

    torch.cuda.reset_peak_memory_stats()
    for _ in range(RECIPE_WARMUP):
        one()
    torch.cuda.synchronize()
    counters = testing.train_counters()
    _zero(counters)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(RECIPE_STEPS + 1)]
    events[0].record()
    for i in range(RECIPE_STEPS):
        one()
        events[i + 1].record()
    torch.cuda.synchronize()
    _hold_launches(report, _launches(counters),
                   testing.train_launches(model.cfg.num_hidden_layers,
                                          "save_matmul_outputs"),
                   RECIPE_STEPS, "recipe_7b", "9c (a) the LLaMA 2 recipe")
    mean_ms = events[0].elapsed_time(events[-1]) / RECIPE_STEPS
    peak = torch.cuda.max_memory_allocated()
    syncs = step_syncs(one)
    torch.cuda.synchronize()
    # one more step traced in three windows: forward and backward, the
    # clip alone, the update without the clip
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_fb:
        with core.remat_policy_guard(step._remat_policy):
            loss = model.loss(ids, ids)
            loss.backward()
        torch.cuda.synchronize()
    clip = opt._grad_clip
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_clip:
        clip(opt._parameter_list)
        torch.cuda.synchronize()
    opt._grad_clip = None
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_opt:
            opt.step()
            opt.clear_grad(set_to_zero=False)
            torch.cuda.synchronize()
    finally:
        opt._grad_clip = clip
    clip_ms = _device_ms(prof_clip, (), "clip")[0].get("clip", 0.0)
    adamw_ms = _device_ms(prof_opt, (), "adamw")[0].get("adamw", 0.0)
    fb_ms = sum(_device_ms(prof_fb, _TRAIN_GROUPS, "other")[0].values())
    losses = [float(x) for x in losses]
    print(f"optim (a) LLaMA 2 recipe, llama_7b bf16 4 x 2048: step_ms="
          f"{mean_ms:.6g} (plain AdamW step {plain_ms:.6g}) peak_mem_gb="
          f"{peak / 1e9:.6g} device ms: fwd+bwd {fb_ms:.6g} clip "
          f"{clip_ms:.6g} adamw {adamw_ms:.6g}; synchronizing calls a "
          f"step {syncs} (plain {plain_syncs}) [{smi_line}]", flush=True)
    print(f"optim (a) lr per step {lrs}; losses "
          f"{[round(x, 6) for x in losses]} (first {RECIPE_WARMUP} "
          f"warm-up)", flush=True)
    check(all(math.isfinite(x) for x in losses),
          "a loss of the LLaMA 2 recipe is not finite")
    check(lrs == want_lrs, f"the recipe's lr sequence {lrs} is not its "
                           f"schedule's {want_lrs}")
    del opt, step, loss, prof_fb, prof_clip, prof_opt


def optimizer_phase(report, plain_1b_ms, smi_line):
    """9c (b) O2 with dynamic loss scaling at llama_1b, (c) every
    optimizer against the CPU and accumulate_steps=2 against one
    full-batch step. The module docstring lists the bars."""
    import gc

    import torch
    t0 = time.perf_counter()
    o2_check(report, plain_1b_ms, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_check(report, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    accumulate_check(report, smi_line)
    print(f"optimizer phase: wall {time.perf_counter() - t0:.3f} s",
          flush=True)


def _llama1b(dtype, seed, layers=None):
    import dataclasses

    import numpy as np
    import torch

    from paddle_tpu_torch.models import llama as L
    cfg = L.llama_1b(dtype=dtype, use_recompute=False,
                     fuse_attention_qkv=True, fuse_mlp=True)
    cfg.max_position_embeddings = max(cfg.max_position_embeddings, TRAIN_SEQ)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = L.LlamaForCausalLM(cfg, device="cuda", generator=gen)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    return model, ids


def o2_norm_kernels(H, smi_line):
    """Rows 1 and 5 at the O2 path's shape, [8192, H] bf16 rows with a
    bf16 weight (the wrappers cast it to f32 each launch), against their
    plain versions, and timed beside the f32 weight the bf16 config
    keeps."""
    import torch

    from paddle_tpu_torch.kernels import fused_norm_residual as kfnr
    from paddle_tpu_torch.kernels import rms_norm as krn
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, H, device="cuda",
                    generator=g).bfloat16()
    r = torch.randn(x.shape, device="cuda", generator=g).bfloat16()
    w32 = 1 + 0.1 * torch.randn(H, device="cuda", generator=g)
    w16 = w32.bfloat16()
    eps = 1e-6
    y = krn.rms_norm(x, w16, eps)
    yp = krn._plain(x.float(), w16.float(), eps)
    (fy, fh) = kfnr.fused_add_rms_norm(x, r, w16, eps)
    fyp, fhp = kfnr._plain(x.float(), r.float(), w16.float(), eps)
    compare("rms_norm", "bfloat16", [("out", y, yp)], " (O2 bf16 weight)")
    compare("fused_add_rms_norm", "bfloat16",
            [("out", fy, fyp), ("residual", fh, fhp)], " (O2 bf16 weight)")
    times = {}
    for tag, w in (("bf16 weight", w16), ("f32 weight", w32)):
        times[tag] = (time_ms(lambda: krn.rms_norm(x, w, eps), 50),
                      time_ms(lambda: kfnr.fused_add_rms_norm(x, r, w, eps),
                              50))
    print("optim (b) norm kernels at [8192, %d] bf16 rows, ms (rms_norm, "
          "fused_add_rms_norm): %s [%s]" % (H, "; ".join(
              f"{k} {a:.6g}, {b:.6g}" for k, (a, b) in times.items()),
              smi_line), flush=True)


def o2_check(report, plain_1b_ms, smi_line):
    """9c (b): llama_1b built f32, `amp.decorate(level="O2")` to bf16,
    AdamW(3e-4 warmup as (a), wd 0.1), the global-norm clip; steps
    without a scaler, then with GradScaler(2**15); one step with a
    non-finite grad skipped bitwise; the next moves the masters."""
    import math

    import torch

    from paddle_tpu_torch import amp
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep

    model, ids = _llama1b("float32", seed=0)
    opt = popt.AdamW(learning_rate=llama2_schedule(popt), weight_decay=0.1,
                     parameters=model.parameters(),
                     grad_clip=pnn.ClipGradByGlobalNorm(1.0))
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    n = len(opt._parameter_list)
    check({p.dtype for p in model.parameters()} == {torch.bfloat16}
          and len(opt._master_weights) == n,
          "amp.decorate(O2) did not cast every parameter with a master")
    o2_norm_kernels(model.cfg.hidden_size, smi_line)
    fn = lambda i, l: model.loss(i, l)            # noqa: E731
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    counters = testing.train_counters()
    runs = {}
    for name, ts in (("unscaled", TrainStep(model, opt, fn)),
                     ("scaled", TrainStep(model, opt, fn, scaler=scaler))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for _ in range(O2_WARMUP):
            losses.append(ts(ids, ids))
            opt._lr.step()
        torch.cuda.synchronize()
        _zero(counters)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(O2_STEPS + 1)]
        events[0].record()
        for i in range(O2_STEPS):
            losses.append(ts(ids, ids))
            opt._lr.step()
            events[i + 1].record()
        torch.cuda.synchronize()
        runs[name] = dict(
            ts=ts, losses=[float(x) for x in losses],
            launches=_launches(counters),
            ms=events[0].elapsed_time(events[-1]) / O2_STEPS,
            peak=torch.cuda.max_memory_allocated(),
            syncs=step_syncs(lambda: ts(ids, ids)))
        torch.cuda.synchronize()
    want = dict(testing.train_launches(model.cfg.num_hidden_layers,
                                       "no remat"),
                fused_cross_entropy=0, fused_cross_entropy_bwd=0)
    _hold_launches(report, runs["scaled"]["launches"], want, O2_STEPS,
                   "o2_1b",
                   "9c (b) O2 with a GradScaler")
    u, s = runs["unscaled"], runs["scaled"]
    for name, r in runs.items():
        print(f"optim (b) O2 {name}: step_ms={r['ms']:.6g} (bf16 config "
              f"step {plain_1b_ms:.6g}) peak_mem_gb={r['peak'] / 1e9:.6g} "
              f"synchronizing calls a step {r['syncs']} losses "
              f"{[round(x, 6) for x in r['losses']]} [{smi_line}]",
              flush=True)
    check(all(math.isfinite(x) for r in runs.values() for x in r["losses"]),
          "an O2 loss is not finite")
    check(s["syncs"] == u["syncs"], f"the scaler adds synchronizing calls: "
          f"{s['syncs']} a step against {u['syncs']}")

    # one step whose grads are non-finite: skipped bitwise
    snap = ([p.detach().clone() for p in model.parameters()],
            {k: v.clone() for k, v in opt._master_weights.items()},
            {k: v.clone() for k, v in opt._state.items()})
    scale, count = scaler.state_dict()["scale"], opt._step_count
    hook = model.model.layers[0].self_attn.o_proj.register_hook(
        lambda g: g * float("inf"))
    try:
        s["ts"](ids, ids)
    finally:
        hook.remove()
    skipped = opt._step_count
    same = (all(torch.equal(a, b) for a, b in zip(snap[0],
                                                  model.parameters()))
            and all(torch.equal(snap[1][k], v)
                    for k, v in opt._master_weights.items())
            and all(torch.equal(snap[2][k], v)
                    for k, v in opt._state.items()))
    after = scaler.state_dict()["scale"]
    moved_loss = float(s["ts"](ids, ids))
    moved = sum(not torch.equal(snap[1][k], v)
                for k, v in opt._master_weights.items())
    print(f"optim (b) skip: parameters, masters and moments bitwise "
          f"{same}; scale {scale:g} -> {after:g}; @step {count} -> "
          f"{count + 1}; the next step (loss {moved_loss:.6g}) moved "
          f"{moved} of {n} masters", flush=True)
    check(same, "a step with a non-finite grad changed a parameter, a "
                "master weight or a moment")
    check(after == scale / 2, "the scale did not halve on a skipped step")
    check(skipped == count + 1, "@step did not advance on the skip")
    check(moved == n and math.isfinite(moved_loss),
          "the step after the skip did not move every master")
    del snap, model, opt, runs, u, s


def zoo_check(report, smi_line):
    """9c (c), first part: a 2-layer llama_1b-width f32 model on the
    card, its copy on the CPU; each of `testing.opt_card_cases` takes 3
    steps on both from the card's grads, LBFGS 3 steps through a closure
    on each device; parameters and accumulators after the last step
    held to the CPU's."""
    import numpy as np
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.models import llama as L

    model, _ = _llama1b("float32", seed=2, layers=2)
    cpu = L.LlamaForCausalLM(model.cfg, device="cpu")
    init = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (ZOO_BATCH, ZOO_SEQ)))
    ids_c = ids.to("cuda")
    pc, ph = list(model.parameters()), list(cpu.parameters())
    counters = testing.train_counters()
    _zero(counters)
    passes = 0

    def reset():
        with torch.no_grad():
            for (k, p), q in zip(model.named_parameters(), ph):
                p.copy_(init[k])
                q.copy_(init[k])

    names = [k for k, _ in model.named_parameters()]

    def worst(oc, oh):
        """The largest max_rel over parameters and accumulators, and the
        tensor it was read at."""
        check(sorted(oc._state) == sorted(oh._state),
              "the card and the CPU keep different accumulators")
        errs = {names[i]: testing.max_rel(a.detach().cpu(), b.detach())
                for i, (a, b) in enumerate(zip(pc, ph))}
        errs.update({f"{names[i]}.{slot}": testing.max_rel(
            v.cpu(), oh._state[(i, slot)])
            for (i, slot), v in oc._state.items()})
        at = max(errs, key=errs.get)
        return errs[at], at

    for name, make in testing.opt_card_cases(popt, pnn).items():
        t0 = time.perf_counter()
        reset()
        oc, oh = make(pc), make(ph)
        syncs = None
        for s in range(ZOO_STEPS):
            model.loss(ids_c, ids_c).backward()
            passes += 1
            for a, b in zip(pc, ph):
                b.grad = a.grad.detach().cpu()
            if s == 1:
                syncs = step_syncs(oc.step)
            else:
                oc.step()
            oh.step()
            oc.clear_grad(set_to_zero=False)
            oh.clear_grad(set_to_zero=False)
            if hasattr(oc._lr, "step"):
                oc._lr.step()
                oh._lr.step()
        err, at = worst(oc, oh)
        print(f"optim (c) {name}: max rel err {err:.6g} at {at} (limit "
              f"{testing.OPT_CARD_RTOL:g}), synchronizing calls a step "
              f"{syncs}, wall {time.perf_counter() - t0:.3f} s", flush=True)
        check(err <= testing.OPT_CARD_RTOL,
              f"{name} on the card disagrees with the CPU")
        check(syncs == 0, f"{name} synchronizes {syncs} times a step")
        del oc, oh

    reset()
    oc = popt.LBFGS(learning_rate=0.1, max_iter=2, history_size=3,
                    parameters=pc)
    oh = popt.LBFGS(learning_rate=0.1, max_iter=2, history_size=3,
                    parameters=ph)

    def closure(m, o, x):
        def run():
            nonlocal passes
            o.clear_grad(set_to_zero=False)
            loss = m.loss(x, x)
            loss.backward()
            passes += x.is_cuda
            return loss
        return run

    err = 0.0
    for s in range(ZOO_STEPS):
        lc = oc.step(closure(model, oc, ids_c))
        lh = oh.step(closure(cpu, oh, ids))
        err = max(err, *(testing.max_rel(a.detach().cpu(), b.detach())
                         for a, b in zip(pc, ph)),
                  abs(lc.item() - lh.item()) / abs(lh.item()))
    print(f"optim (c) lbfgs (closure on each device): max rel err "
          f"{err:.6g} (limit {testing.OPT_LBFGS_RTOL:g}) [{smi_line}]",
          flush=True)
    check(err <= testing.OPT_LBFGS_RTOL, "LBFGS on the card disagrees with "
                                         "the CPU")
    want = dict(testing.train_launches(2, "no remat"),
                fused_cross_entropy=0, fused_cross_entropy_bwd=0)
    _hold_launches(report, _launches(counters), want, passes,
                   "optimizer_zoo",
                   f"9c (c) the optimizers' {passes} forward and backward "
                   f"passes")
    del model, cpu, oc, oh


def accumulate_check(report, smi_line):
    """9c (c), second part: llama_1b bf16 at 4 x 2048, one AdamW step
    with accumulate_steps=2 against one full-batch step from the same
    weights: loss and weights within testing's ACCUM_* limits, peak
    memory lower."""
    import gc

    import torch

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep

    model, ids = _llama1b("bfloat16", seed=3)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    counters = testing.train_counters()
    out = {}
    for k in (1, 2):
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(init[name])
        opt = popt.AdamW(learning_rate=3e-4, weight_decay=0.1,
                         parameters=model.parameters())
        ts = TrainStep(model, opt, lambda i, l: model.loss(i, l),
                       accumulate_steps=k)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero(counters)
        loss = float(ts(ids, ids))
        # the step's own peak: above what was held when it began (the
        # weights kept from the other run among it)
        out[k] = dict(loss=loss,
                      peak=torch.cuda.max_memory_allocated() - base,
                      launches=_launches(counters),
                      weights={n: p.detach().clone()
                               for n, p in model.named_parameters()})
        del opt, ts
    want = dict(testing.train_launches(model.cfg.num_hidden_layers,
                                       "no remat"),
                fused_cross_entropy=0, fused_cross_entropy_bwd=0)
    _hold_launches(report, out[2]["launches"], want, 2, "accumulate_1b",
                   "9c (c) accumulate_steps=2")
    full, acc = out[1], out[2]
    loss_err = abs(acc["loss"] - full["loss"]) / abs(full["loss"])
    rl2 = {n: ((acc["weights"][n].float() - w.float()).norm()
               / w.float().norm()).item()
           for n, w in full["weights"].items()}
    worst = max(rl2, key=rl2.get)
    print(f"optim (c) accumulate_steps=2 vs one full-batch step, llama_1b "
          f"bf16 4 x 2048: loss {acc['loss']:.8g} vs {full['loss']:.8g} "
          f"rel err {loss_err:.6g} (limit {testing.ACCUM_LOSS_RTOL:g}); "
          f"weights worst rel L2 {rl2[worst]:.6g} at {worst} (limit "
          f"{testing.ACCUM_WEIGHT_RL2:g}); the step's peak above its start, "
          f"GB {acc['peak'] / 1e9:.6g} vs {full['peak'] / 1e9:.6g} "
          f"[{smi_line}]", flush=True)
    check(loss_err <= testing.ACCUM_LOSS_RTOL
          and rl2[worst] <= testing.ACCUM_WEIGHT_RL2,
          "accumulate_steps=2 disagrees with the full-batch step")
    check(acc["peak"] < full["peak"],
          "accumulate_steps=2 did not lower peak memory")
    del model, init, out, full, acc


def surface_phase(report, smi_line):
    """The nn.functional attention surface in bf16. At bert_base
    attention width on the BERT phase's lengths: sdpa with the boolean
    [16, 1, 1, 512] mask (segment kernels), sdpa with the additive float
    mask (0 valid, -1e4 padding: the bias route, one bias forward, dkv
    and dq launch, no block-stats launch) and flash_attn_unpadded on the
    same batch packed to [sum lengths, 12, 64]: each against its plain
    route and against each other at valid rows, output and grads,
    within testing.SURFACE_RTOL. At llama_7b attention width: a packed
    causal flash_attn_unpadded over 8192 tokens of `testing.
    packed_lengths()` documents, and a causal alibi flash_attention_
    biased at 4 x 2048 and at 2 x 4096 (the bias kernels, launched once
    each) whose peak memory above its inputs must stay under
    `alibi_peak_bound`; forward
    and backward each, timed. The biased route (the float mask, the 4 x
    2048 alibi case) is timed beside SDPA with the same bias as its
    attn_mask (`sdpa_library`)."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.nn import functional as TF

    counters = testing.attention_counters()
    dt = torch.bfloat16
    B, S, H, D = BERT_BATCH, BERT_SEQ, 12, 64
    lengths = testing.bert_lengths(B, S)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                               device="cuda").to(dt) for _ in range(4))
    valid = (torch.arange(S, device="cuda")[None, :]
             < torch.tensor(lengths, device="cuda")[:, None])
    do = do * valid[:, :, None, None]
    cu = torch.tensor([0] + lengths, device="cuda").cumsum(0).to(torch.int32)
    scale = D ** -0.5

    def sdpa_bool(a, b, c):
        return TF.scaled_dot_product_attention(
            a, b, c, attn_mask=valid[:, None, None, :])

    fmask = torch.where(valid, 0.0, -1e4).float()[:, None, None, :]

    def sdpa_float(a, b, c):
        return TF.scaled_dot_product_attention(a, b, c, attn_mask=fmask)

    def unpadded(a, b, c):
        out, _ = TF.flash_attn_unpadded(a[valid], b[valid], c[valid], cu, cu,
                                        S, S, scale)
        full = torch.zeros_like(a)
        full[valid] = out
        return full

    routes = {"sdpa_bool_mask": (sdpa_bool, SEG_ROUTE_LAUNCHES),
              "sdpa_float_mask": (sdpa_float, BIAS_ROUTE_LAUNCHES),
              "flash_attn_unpadded": (unpadded, SEG_ROUTE_LAUNCHES)}

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        torch.cuda.synchronize()
        return [out.detach()] + [t.grad for t in leaves]

    # the block-stats kernel is off the biased route now: its main-path
    # count is the surface's, 0 (every route below checks it)
    add_launches(report, "block_attention_stats", "surface", 0)
    results = {}
    for name, (fn, want) in routes.items():
        for c in counters.values():
            c.launches = 0
        got = run(fn)
        launches = {n: c.launches for n, c in counters.items()}
        _expect_launches(counters, launches, want, f"surface {name}")
        for kname, n in launches.items():
            if n:
                add_launches(report, kname, f"surface_{name}", n)
        with plain_routes():
            plain = run(fn)
        errs = [_rel(a[valid], b[valid]) for a, b in zip(got, plain)]
        fwd_ms = time_ms(lambda: fn(q, k, v), 10)
        fb_ms = time_ms(lambda: run(fn), 5)
        ok = max(errs) <= testing.SURFACE_RTOL and all(
            bool(torch.isfinite(t).all()) for t in got)
        print(f"surface {name} [B{B} S{S} H{H} D{D} bf16]: fwd_ms="
              f"{fwd_ms:.6g} fwd_bwd_ms={fb_ms:.6g}; kernel vs plain route "
              f"at valid rows, max rel (out, dq, dk, dv) "
              f"{[round(e, 6) for e in errs]} (limit "
              f"{testing.SURFACE_RTOL:g}) {'ok' if ok else 'MISS'} "
              f"[{smi_line}]", flush=True)
        check(ok, f"surface {name}: the kernel route disagrees with its "
                  f"plain route")
        results[name] = got
        if name == "sdpa_float_mask":
            biased_times(report, name, fwd_ms, fb_ms,
                         sdpa_library(q, k, v, do, fmask), smi_line)
    base = results["sdpa_bool_mask"]
    for name in ("sdpa_float_mask", "flash_attn_unpadded"):
        errs = [_rel(a[valid], b[valid]) for a, b in zip(results[name],
                                                          base)]
        ok = max(errs) <= testing.SURFACE_RTOL
        print(f"surface {name} vs sdpa_bool_mask at valid rows: max rel "
              f"(out, dq, dk, dv) {[round(e, 6) for e in errs]} (limit "
              f"{testing.SURFACE_RTOL:g}) {'ok' if ok else 'MISS'}",
              flush=True)
        check(ok, f"surface {name} disagrees with sdpa_bool_mask")
    del results, base, q, k, v, do
    torch.cuda.empty_cache()

    # llama_7b attention width: packed causal documents
    lengths7 = testing.packed_lengths()
    T, H7, D7 = sum(lengths7), 32, 128
    q, k, v, do = (torch.randn((T, H7, D7), generator=gen,
                               device="cuda").to(dt) for _ in range(4))
    cu7 = torch.tensor([0] + lengths7, device="cuda").cumsum(0).to(
        torch.int32)

    def packed(a, b, c):
        return TF.flash_attn_unpadded(a, b, c, cu7, cu7, max(lengths7),
                                      max(lengths7), D7 ** -0.5,
                                      causal=True)[0]

    surface_7b(report, counters, "packed_causal", packed, (q, k, v), do,
        SEG_ROUTE_LAUNCHES, f"{T} tokens in documents "
        f"{lengths7}, H{H7} D{D7} bf16", smi_line)
    del q, k, v, do
    torch.cuda.empty_cache()

    # llama_7b attention width: causal alibi at 4 x 2048 (timed beside
    # SDPA) and at 2 x 4096, where one f32 [B, H, Sq, Sk] score buffer
    # (4.29 GB) is larger than the peak bound, so a route that held one,
    # or that kept every 512-key chunk's bias (8 x 0.268 GB), would fail
    # the check
    slopes = testing.alibi_slopes(H7)

    def alibi(a, b, c):
        return kfa.flash_attention_biased(a, b, c, "alibi", slopes,
                                          causal=True)

    C = 512
    for B7, S7 in ((4, 2048), (2, 4096)):
        q, k, v, do = (torch.randn((B7, S7, H7, D7), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        name = "alibi_causal" if S7 == 2048 else f"alibi_causal_{S7}"
        bound = alibi_peak_bound(B7, S7, H7, D7, C)
        full = B7 * H7 * S7 * S7 * 4
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd_ms, fb_ms = surface_7b(
            report, counters, name, alibi, (q, k, v), do,
            BIAS_ROUTE_LAUNCHES, f"[{B7}, {S7}, {H7}, {D7}] bf16", smi_line)
        peak = torch.cuda.max_memory_allocated() - resident
        print(f"surface {name}: fwd+bwd peak memory above the inputs "
              f"{peak / 1e9:.6g} GB (bound {bound / 1e9:.6g} GB = "
              f"alibi_peak_bound at chunk {C}; one f32 [B, H, Sq, Sk] "
              f"score buffer would be {full / 1e9:.6g} GB) "
              f"{'ok' if peak <= bound else 'MISS'}", flush=True)
        check(peak <= bound, f"{name} fwd+bwd peak {peak} B above the "
                             f"inputs exceeds its bound {bound} B")
        if S7 == 2048:
            bias = kfa._bias_chunk("alibi", slopes, S7, 0, S7, True, None)
            biased_times(report, name, fwd_ms, fb_ms,
                         sdpa_library(q, k, v, do, bias), smi_line)
            del bias
        else:
            check(bound < full, f"{name}: the peak bound {bound} B is not "
                                f"below one score buffer {full} B")
        del q, k, v, do
        torch.cuda.empty_cache()


def sdpa_library(q, k, v, do, bias):
    """The library call for the biased route: one torch SDPA on the same
    bf16 BSHD inputs with the route's f32 bias (the dense [B, 1, 1, Sk]
    mask, or the alibi bias with the causal mask folded in as -1e30,
    [1, H, Sq, Sk]) as its additive attn_mask; forward and forward +
    backward ms by CUDA events."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
    do_t = do.transpose(1, 2)

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        return torch.autograd.grad(o, leaves, do_t)

    return {"fwd_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias), 10),
            "fwd_bwd_ms": time_ms(fwd_bwd, 5)}


def biased_times(report, name, fwd_ms, fb_ms, library, smi_line):
    """Row 12 (flash_attention_biased, the route over the bias kernels)
    beside its library call: printed, and kept under the bias forward
    entry's "routes" key."""
    print(f"surface {name}: route fwd_ms={fwd_ms:.6g} fwd_bwd_ms="
          f"{fb_ms:.6g}; library SDPA with the bias as attn_mask fwd_ms="
          f"{library['fwd_ms']:.6g} fwd_bwd_ms={library['fwd_bwd_ms']:.6g} "
          f"[{smi_line}]", flush=True)
    report["flash_attention_bias_fwd"].setdefault("routes", {})[name] = {
        "fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms, "library": library}


# flash_attention_biased's launches per forward + backward: one bias
# forward, one dkv, one dq; no block-stats kernel
# one forward and backward of the segment route: the forward, the delta
# pre-pass, dkv and dq
SEG_ROUTE_LAUNCHES = {"flash_attention_seg_fwd": 1,
                      "flash_attention_delta": 1,
                      "flash_attention_seg_dkv": 1,
                      "flash_attention_seg_dq": 1}
BIAS_ROUTE_LAUNCHES = {"flash_attention_bias_fwd": 1,
                       "flash_attention_bias_dkv": 1,
                       "flash_attention_bias_dq": 1}


def alibi_peak_bound(B, Sq, H, D, C):
    """The alibi route's peak memory bound: three f32 score-shaped chunk
    buffers [B, H, Sq, C] (the backward's P and dS and the chunk bias or
    its mask) and eight f32 buffers of q's size [B, Sq, H, D] (q, dO,
    the output and the forward's merged o in f32; dq, dk, dv and a merge
    temporary). It grows with the chunk C, not with Sk."""
    return 3 * B * H * Sq * C * 4 + 8 * B * Sq * H * D * 4


def surface_7b(report, counters, name, fn, inputs, do, want, what,
               smi_line):
    """One 7B-width surface case: a forward and backward with launch
    counts `want` and finite results, then the forward and the forward +
    backward timed by CUDA events; returns (fwd_ms, fwd_bwd_ms)."""
    import torch
    for c in counters.values():
        c.launches = 0
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    _expect_launches(counters, launches, want, f"surface {name}")
    for kname, n in launches.items():
        if n:
            add_launches(report, kname, f"surface_{name}", n)
    check(all(bool(torch.isfinite(t).all())
              for t in [out] + [t.grad for t in leaves]),
          f"surface {name}: a non-finite output or grad")
    del out, leaves
    fwd_ms = time_ms(lambda: fn(*inputs), 5, warmup=1)

    def fwd_bwd():
        ls = [t.detach().requires_grad_() for t in inputs]
        fn(*ls).backward(do)

    fb_ms = time_ms(fwd_bwd, 3, warmup=1)
    print(f"surface {name} ({what}): fwd_ms={fwd_ms:.6g} fwd_bwd_ms="
          f"{fb_ms:.6g} [{smi_line}]", flush=True)
    return fwd_ms, fb_ms


# ------------------------------------------------- phase 11: nn.Transformer
#
# Transformer base for WMT14 En-De (Vaswani et al. 2017, Table 3 "base"):
# 6 + 6 layers, d_model 512, d_ff 2048, 8 heads of 64, P_drop 0.1, label
# smoothing 0.1, a shared 37000-token vocabulary whose embedding is also
# the output projection (scaled by sqrt(d_model) on input), sinusoidal
# positions, Adam (0.9, 0.98, 1e-9) under NoamDecay(512, 4000); f32, TF32
# off. `nn.Transformer`'s own defaults are these widths.
TR_VOCAB, TR_D, TR_FF, TR_HEADS, TR_LAYERS = 37000, 512, 2048, 8, 6
TR_DROPOUT, TR_SMOOTH = 0.1, 0.1
TR_PAD, TR_BOS, TR_EOS = 0, 1, 2
TR_BATCH, TR_WARMUP, TR_STEPS = 64, 2, 5
TR_BEAM_SOURCES, TR_MAX_STEPS = 16, 64
# the training step's device kernels -> group, first match wins; the
# optimizer's update is traced alone ("adam")
_TR_GROUPS = (("gemm", "cublas"), ("nvjet", "cublas"), ("xmma", "cublas"),
              ("cutlass", "cublas"))


def _sinusoid(n, d, device):
    import torch
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(10000.0, 2 * i / d)
    out = torch.zeros((n, d), device=device)
    out[:, 0::2], out[:, 1::2] = torch.sin(ang), torch.cos(ang)
    return out


def _seq2seq(layers, dropout, seed):
    """Transformer base as a translation model, from the port's public
    pieces (`nn.Embedding`, `nn.Transformer`, `nn.Dropout`, `nn.functional.
    cross_entropy`), on the card, weights drawn from a generator seeded
    `seed`."""
    import math

    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.nn import functional as F

    class Seq2Seq(pnn.Layer):
        def __init__(self):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            kw = dict(device="cuda", generator=gen)
            super().__init__(**kw)
            self.emb = pnn.Embedding(TR_VOCAB, TR_D, padding_idx=TR_PAD, **kw)
            self.tr = pnn.Transformer(TR_D, TR_HEADS, layers, layers, TR_FF,
                                      dropout, **kw)
            self.drop = pnn.Dropout(dropout)
            self.register_buffer("pe", _sinusoid(testing.TRANSFORMER_MAXLEN,
                                                 TR_D, "cuda"),
                                 persistable=False)

        def embed(self, ids):
            return self.emb(ids) * math.sqrt(TR_D)

        def inputs(self, ids):
            return self.drop(self.embed(ids) + self.pe[:ids.shape[1]])

        def logits(self, h):
            return h @ self.emb.weight.T

        def loss(self, src, tgt_in, tgt_out, src_mask, tgt_mask):
            h = self.tr(self.inputs(src), self.inputs(tgt_in), src_mask,
                        tgt_mask, src_mask)
            return F.cross_entropy(self.logits(h), tgt_out,
                                   ignore_index=TR_PAD,
                                   label_smoothing=TR_SMOOTH)

        def cell(self, inp, states):
            """One beam-search step of the decoder: the token's input plus
            its position, through every layer's growing Cache (made at the
            first step) and its StaticCache, under the source mask."""
            incr, static, mask = states
            pos = incr[0].k.shape[1] if incr else 0
            x = (inp + self.pe[pos])[:, None, :]
            if not incr:
                incr = [layer.self_attn.gen_cache(x)
                        for layer in self.tr.decoder.layers]
            out, new = self.tr.decoder(x, None, None, mask,
                                       list(zip(incr, static)))
            return out[:, 0], ([c[0] for c in new], [c[1] for c in new],
                               mask)

    return Seq2Seq()


def transformer_batch(equal=False):
    """The training batch: 64 sentence pairs, source and target lengths
    default_rng(0).integers(16, 129) (`testing.transformer_lengths`: the
    first 64 draws are the sources'), token ids default_rng(2) in [3,
    37000) padded with 0 to 128; a target is BOS, its tokens, EOS. ->
    (src, tgt_in [B, T], tgt_out [B, T], the source's valid mask [B,
    128]): T = 127, or with `equal` 128, the target padded one further so
    that it is as long as the source."""
    import numpy as np
    import torch

    from paddle_tpu_torch import testing
    S = testing.TRANSFORMER_MAXLEN
    rng = np.random.default_rng(0)
    src_len = rng.integers(16, S + 1, TR_BATCH)
    tgt_len = rng.integers(16, S + 1, TR_BATCH)
    check(list(src_len) == testing.transformer_lengths(TR_BATCH, 0),
          "the source lengths are not testing.transformer_lengths'")
    ids = np.random.default_rng(2).integers(3, TR_VOCAB, (2, TR_BATCH, S))
    pos = np.arange(S)[None, :]
    src = np.where(pos < src_len[:, None], ids[0], TR_PAD)
    tgt = np.where(pos < tgt_len[:, None] - 1, ids[1], TR_PAD)
    tgt = np.concatenate([np.full((TR_BATCH, 1), TR_BOS),
                          tgt if equal else tgt[:, :-1]], 1)
    tgt[np.arange(TR_BATCH), tgt_len - 1] = TR_EOS
    src, tgt = (torch.from_numpy(a).to("cuda") for a in (src, tgt))
    return src, tgt[:, :-1], tgt[:, 1:], src != TR_PAD


def transformer_phase(report, smi_line):
    """Phase 11 (module docstring): (a) training, (b) the kernel route
    against the plain route with float and bool masks, (c) beam search.
    Its kernel entries (d) run beside the kernel phase, early in the
    run, where the profiler's traces hold every launch
    (`transformer_kernels`)."""
    import gc

    import torch
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    transformer_train(report, smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    routes = {mask: transformer_route_check(report, mask, smi_line)
              for mask in ("float", "bool")}
    transformer_mask_agreement(routes, smi_line)
    del routes
    gc.collect()
    torch.cuda.empty_cache()
    transformer_beam(report, smi_line)
    print(f"transformer phase: wall {time.perf_counter() - t0:.3f} s",
          flush=True)


def transformer_train(report, smi_line):
    """(a) Transformer base through TrainStep: label-smoothed cross-
    entropy over the non-pad target tokens, Adam(0.9, 0.98, 1e-9) under
    NoamDecay(512, 4000) stepped after each step, dropout 0.1 (so
    attention takes the reference's dense route: no attention kernel
    launches, and label smoothing keeps the fused cross-entropy off);
    TR_WARMUP warm-up and TR_STEPS timed steps by CUDA events, target
    tokens/s, peak memory; one more step traced, its device time by
    group and busy share."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import lr as plr

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _seq2seq(TR_LAYERS, TR_DROPOUT, seed=0)
    model.train()
    src, tgt_in, tgt_out, valid = transformer_batch()
    src_mask = torch.where(valid, 0.0, -1e9).float()[:, None, None, :]
    tgt_mask = pnn.Transformer.generate_square_subsequent_mask(
        tgt_in.shape[1], device="cuda")
    sched = plr.NoamDecay(d_model=TR_D, warmup_steps=4000)
    opt = popt.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                    epsilon=1e-9, parameters=model.parameters())
    step = TrainStep(model, opt, model.loss)
    batch = (src, tgt_in, tgt_out, src_mask, tgt_mask)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = int((tgt_out != TR_PAD).sum())
    torch.cuda.synchronize()
    print(f"transformer train: base ({TR_LAYERS} + {TR_LAYERS} layers, "
          f"d_model {TR_D}, d_ff {TR_FF}, {TR_HEADS} heads, vocab "
          f"{TR_VOCAB}) f32 built in {time.perf_counter() - t0:.3f} s, "
          f"{n_params} parameters, batch {TR_BATCH} pairs, "
          f"{int(valid.sum())} source and {tokens} target tokens",
          flush=True)
    losses = []
    for _ in range(TR_WARMUP):
        losses.append(step(*batch))
        sched.step()
    torch.cuda.synchronize()
    counters = testing.transformer_counters()
    _zero(counters)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TR_STEPS + 1)]
    wall0 = time.perf_counter()
    events[0].record()
    for i in range(TR_STEPS):
        losses.append(step(*batch))
        sched.step()
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    launches = _launches(counters)
    losses = [float(x) for x in losses]
    mean_ms = events[0].elapsed_time(events[-1]) / TR_STEPS
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TR_STEPS)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"transformer train: losses={[round(x, 6) for x in losses]} "
          f"(first {TR_WARMUP} warm-up), lr {sched.last_lr:.6g}", flush=True)
    print(f"transformer train: step_ms={mean_ms:.6g} per step "
          f"{[round(x, 4) for x in step_ms]} wall_per_step_ms="
          f"{1e3 * wall / TR_STEPS:.6g} target_tokens_per_s="
          f"{tokens / (mean_ms / 1e3):.6g} peak_mem_gb={peak:.6g} "
          f"[{smi_line}]", flush=True)
    check(all(math.isfinite(x) for x in losses),
          "a transformer training loss is not finite")
    _hold_launches(report, launches, {n: 0 for n in launches}, TR_STEPS,
                   "transformer_train", f"transformer train, {TR_STEPS} "
                   f"steps (dropout 0.1: the dense route; label "
                   f"smoothing: no fused cross-entropy)")

    prof_fb = device_trace(lambda: model.loss(*batch).backward())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_opt:
        opt.step()
        opt.clear_grad(set_to_zero=False)
        torch.cuda.synchronize()
    groups, others = _device_ms(prof_fb, _TR_GROUPS, "plain_torch")
    groups["adam"] = _device_ms(prof_opt, (), "adam")[0].get("adam", 0.0)
    busy = sum(groups.values())
    if busy == 0.0:
        print("transformer train profile: not measured (the profiler saw "
              "no device time)", flush=True)
    else:
        parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}"
                         for g in ("cublas", "adam", "plain_torch"))
        print(f"transformer train profile (device ms, one step): {parts} "
              f"total={busy:.6g} busy_share={busy / mean_ms:.4f} "
              f"[{smi_line}]", flush=True)
        top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
        print("transformer train profile, largest plain torch kernels "
              "(ms): " + "; ".join(f"{k[:70]}={ms:.4g}" for k, ms in top),
              flush=True)
    del model, opt, step, prof_fb, prof_opt


def _grad_rel(grads, ref):
    """Each parameter's grad relative L2 against ref's; a k_proj bias's
    grad is 0 analytically (one constant added to every key's score
    leaves the softmax as it is): both sides read summation noise there,
    held against the same layer's q_proj bias grad."""
    return {n: ((grads[n] - ref[n]).norm()
                / ref[n.replace("k_proj.bias", "q_proj.bias")].norm()
                .clamp_min(1e-30)).item() for n in ref}


def transformer_route_check(report, mask, smi_line):
    """(b) a 2-layer Transformer base at dropout 0, one train-mode
    forward and backward of the training batch's loss, its targets as
    long as its sources (`transformer_batch(equal=True)`), on the kernel
    route against `plain_routes()`: mask "float" (every mask additive:
    row 12's bias forward, dkv and dq) or "bool" (a bool [B, 1, 1, S]
    source mask: row 10's segment forward, delta, dkv and dq for the
    encoder's self and the decoder's cross attention; the causal target
    mask stays float). |loss difference| / |loss| and each parameter's
    grad relative L2 (`_grad_rel`) within testing's TRANSFORMER limits;
    launches exact (`testing.transformer_train_launches`). -> the kernel
    route's (loss, grads)."""
    import torch

    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import testing

    L = 2
    model = _seq2seq(L, 0.0, seed=1)
    model.train()
    src, tgt_in, tgt_out, valid = transformer_batch(equal=True)
    src_mask = (torch.where(valid, 0.0, -1e9).float() if mask == "float"
                else valid)[:, None, None, :]
    tgt_mask = pnn.Transformer.generate_square_subsequent_mask(
        tgt_in.shape[1], device="cuda")
    batch = (src, tgt_in, tgt_out, src_mask, tgt_mask)

    def loss_and_grads():
        loss = model.loss(*batch)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        for p in model.parameters():
            p.grad = None
        return loss.item(), grads

    counters = testing.transformer_counters()
    _zero(counters)
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    tag = f"transformer (b) {mask} masks"
    want = testing.transformer_train_launches(L, mask)
    _hold_launches(report, _launches(counters),
                   {n: want.get(n, 0) for n in counters}, 1,
                   f"transformer_route_{mask}", f"{tag}, one pass")
    with plain_routes():
        loss_p, grads_p = loss_and_grads()
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(set(grads_k) == set(grads_p), f"{tag}: the routes' grads differ "
          f"in which parameters they reach")
    rel = _grad_rel(grads_k, grads_p)
    worst = max(rel, key=rel.get)
    ok = (loss_err <= testing.TRANSFORMER_LOSS_RTOL
          and rel[worst] <= testing.TRANSFORMER_GRAD_RTOL)
    print(f"{tag} (2 + 2 layers, full width, dropout 0): loss kernel "
          f"{loss_k:.8g} plain {loss_p:.8g} rel_err={loss_err:.6g} (limit "
          f"{testing.TRANSFORMER_LOSS_RTOL:g}); grads max rel L2 "
          f"{rel[worst]:.6g} at {worst} (limit "
          f"{testing.TRANSFORMER_GRAD_RTOL:g}) {'ok' if ok else 'MISS'} "
          f"[{smi_line}]", flush=True)
    print(f"{tag}, largest grad rel L2: " + "; ".join(
        f"{n}={rel[n]:.4g}" for n in sorted(rel, key=rel.get)[-6:]),
        flush=True)
    check(ok, f"{tag}: the kernel route disagrees with the plain route")
    del model, grads_p
    torch.cuda.empty_cache()
    return loss_k, grads_k


def transformer_mask_agreement(routes, smi_line):
    """(b) the bool source mask against the float one on the kernel
    route, same weights and batch (routes: mask -> (loss, grads) of
    `transformer_route_check`). Both mask the same keys, so a valid
    target row at a padded source index must attend to the valid keys
    under either: the loss and every grad within testing's TRANSFORMER
    limits."""
    from paddle_tpu_torch import testing
    (loss_f, grads_f), (loss_b, grads_b) = routes["float"], routes["bool"]
    loss_err = abs(loss_b - loss_f) / abs(loss_f)
    rel = _grad_rel(grads_b, grads_f)
    worst = max(rel, key=rel.get)
    ok = (loss_err <= testing.TRANSFORMER_LOSS_RTOL
          and rel[worst] <= testing.TRANSFORMER_GRAD_RTOL)
    print(f"transformer (b) bool against float masks (kernel route, T = S "
          f"= {testing.TRANSFORMER_MAXLEN}): loss bool {loss_b:.8g} float "
          f"{loss_f:.8g} rel_err={loss_err:.6g}; grads max rel L2 "
          f"{rel[worst]:.6g} at {worst} {'ok' if ok else 'MISS'} "
          f"[{smi_line}]", flush=True)
    check(ok, "transformer (b): the bool source mask disagrees with the "
              "float one")


def _count_kernels(prof, fragment):
    """The launches of the device kernels whose names hold `fragment` in
    a torch.profiler trace."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and fragment in e.key)


def _nonzero(launches):
    return {n: k for n, k in launches.items() if k}


def _beam_decode(model, src, src_mask, record=None, step_launches=None):
    """Beam search over the encoded sources: the encoder and the
    decoder's StaticCaches, then `_beam_steps`. -> (paths, lengths,
    encoder ms, decode ms, steps), the times by CUDA events."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with torch.no_grad():
        ev[0].record()
        static = _beam_encode(model, src, src_mask)
        ev[1].record()
        paths, lengths = _beam_steps(model, static, src_mask, record,
                                     step_launches)
        ev[2].record()
    torch.cuda.synchronize()
    return (paths, lengths, ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]), paths.shape[-1])


def _beam_encode(model, src, src_mask):
    """The encoder's output projected once into every decoder layer's
    StaticCache (`gen_cache(do_zip=True)`)."""
    memory = model.tr.encoder(model.inputs(src), src_mask)
    return model.tr.decoder.gen_cache(memory, do_zip=True)[1]


def _beam_steps(model, static, src_mask, record=None, step_launches=None):
    """`nn.BeamSearchDecoder` (beam testing.TRANSFORMER_BEAM, BOS to EOS)
    on the model's cell and `nn.dynamic_decode(max_step_num=
    TR_MAX_STEPS)`, from the StaticCaches. record: a list that receives
    each step's (log-probs, finished, logits, next tokens, parents);
    step_launches: (counters, list) that receives each step's launches.
    -> (paths, lengths)."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch import testing

    class Decoder(pnn.BeamSearchDecoder):
        def step(self, time, tokens, state):
            before = None if step_launches is None else \
                _launches(step_launches[0])
            out = super().step(time, tokens, state)
            if before is not None:
                after = _launches(step_launches[0])
                step_launches[1].append(
                    {n: after[n] - before[n] for n in after})
            if record is not None:
                record.append((state[1], state[2], self.last_logits,
                               out[0], out[1]))
            return out

    def output_fn(h):
        logits = model.logits(h)
        dec.last_logits = logits
        return logits

    dec = Decoder(model.cell, TR_BOS, TR_EOS, testing.TRANSFORMER_BEAM,
                  embedding_fn=model.embed, output_fn=output_fn)
    paths, _, lengths = pnn.dynamic_decode(
        dec, ([], static, src_mask), TR_MAX_STEPS, return_length=True)
    return paths, lengths


def transformer_beam(report, smi_line):
    """(c) beam search on Transformer base (phase (a)'s widths, weights
    from a seeded generator, eval): 16 sources of default_rng(1)
    lengths in [16, 128] padded to 128, beam 4, at most 64 steps. The
    encoder launches 6 row-12 bias forwards; each decode step 6 row-12
    bias forwards (cross-attention against the StaticCache) and 6
    row-10 forwards (the self-attention over the growing Cache: the
    one-length kernel at the first step, the segment kernel without ids
    after it), exactly. Encoder ms, ms a decode step, generated tokens/s
    and the host's share of a step (1 - the device time of the decode
    steps, traced alone, over their time by events; "not measured" when
    the trace lost one of their attention forwards). The token paths and lengths equal those of the same
    decode on `plain_routes()`, or first differ at a step where that
    batch row's top candidates lie within testing.BEAM_GAP_LIMIT."""
    import numpy as np
    import torch

    from paddle_tpu_torch import testing

    L, nb = TR_LAYERS, TR_BEAM_SOURCES
    model = _seq2seq(L, TR_DROPOUT, seed=3).eval()
    S = testing.TRANSFORMER_MAXLEN
    lengths = testing.transformer_lengths(nb, 1)
    ids = np.random.default_rng(4).integers(3, TR_VOCAB, (nb, S))
    valid = np.arange(S)[None, :] < np.array(lengths)[:, None]
    src = torch.from_numpy(np.where(valid, ids, TR_PAD)).to("cuda")
    src_mask = testing.transformer_src_mask(lengths, S, "cuda")
    _beam_decode(model, src[:2], src_mask[:2])          # warm-up
    counters = testing.transformer_counters()
    per_step = []
    _zero(counters)
    wall0 = time.perf_counter()
    paths, lens, enc_ms, dec_ms, steps = _beam_decode(
        model, src, src_mask, step_launches=(counters, per_step))
    wall = time.perf_counter() - wall0
    launches = _launches(counters)
    enc_launches = {n: launches[n] - sum(s[n] for s in per_step)
                    for n in launches}
    _hold_launches(report, enc_launches,
                   {n: int(n == "flash_attention_bias_fwd") * L
                    for n in counters}, 1, "transformer_encoder",
                   "transformer (c) encoder forward")
    for t, got in enumerate(per_step):
        want = testing.transformer_decode_launches(L, t)
        for n, k in got.items():
            check(k == want.get(n, 0), f"transformer (c) decode step {t}: "
                  f"{n} launched {k} times, expected {want.get(n, 0)}")
    for n in counters:
        add_launches(report, n, "transformer_decode",
                     sum(s[n] for s in per_step))
    print(f"transformer (c) decode: {steps} steps, launches a step exact "
          f"(step 0: {_nonzero(per_step[0])}; then "
          f"{_nonzero(per_step[-1])})", flush=True)
    beam_tokens = nb * testing.TRANSFORMER_BEAM * steps
    print(f"transformer (c) beam search: {nb} sources (lengths {lengths}), "
          f"beam {testing.TRANSFORMER_BEAM}, {steps} steps: encoder_ms="
          f"{enc_ms:.6g} decode_ms={dec_ms:.6g} ms_per_step="
          f"{dec_ms / steps:.6g} generated_tokens_per_s="
          f"{nb * steps / (dec_ms / 1e3):.6g} (beam tokens "
          f"{beam_tokens / (dec_ms / 1e3):.6g}/s) wall_s={wall:.4g} "
          f"[{smi_line}]", flush=True)
    # the decode steps alone traced: every step's 2L attention forwards
    # ("flash_fwd_" kernels) must be in the trace, or it lost records
    with torch.no_grad():
        static = _beam_encode(model, src, src_mask)
    torch.cuda.synchronize()
    want_fwd = 2 * L * steps

    def complete(prof):
        return _count_kernels(prof, "flash_fwd_") == want_fwd

    with torch.no_grad():
        prof = device_trace(lambda: _beam_steps(model, static, src_mask),
                            complete=complete)
    dev_ms = sum(_device_ms(prof, (), "all")[0].values())
    got_fwd = _count_kernels(prof, "flash_fwd_")
    if dev_ms == 0.0 or got_fwd != want_fwd:
        print(f"transformer (c) decode profile: not measured (the trace "
              f"holds {got_fwd} of the {want_fwd} attention forwards)",
              flush=True)
    else:
        print(f"transformer (c) decode profile: device ms a step "
              f"{dev_ms / steps:.6g} (the decode steps alone) against "
              f"{dec_ms / steps:.6g} ms by events: host_share="
              f"{1.0 - dev_ms / dec_ms:.4f} [{smi_line}]", flush=True)
    del static, prof

    rec = []
    with plain_routes():
        paths_p, lens_p, _, _, steps_p = _beam_decode(model, src, src_mask,
                                                      record=rec)
    same = (steps == steps_p and torch.equal(paths, paths_p)
            and torch.equal(lens, lens_p))
    if same:
        print(f"transformer (c): token paths and lengths equal the plain "
              f"route's ({steps} steps)", flush=True)
    else:
        rec_k = []
        _beam_decode(model, src, src_mask, record=rec_k)
        for b in range(nb):
            first = next((t for t in range(min(len(rec), len(rec_k)))
                          if not (torch.equal(rec[t][3][b], rec_k[t][3][b])
                                  and torch.equal(rec[t][4][b],
                                                  rec_k[t][4][b]))), None)
            if first is None:
                continue
            lp, fin, logits = rec[first][:3]
            gap = float(testing.beam_gaps(lp, fin, logits, TR_EOS,
                                          testing.TRANSFORMER_BEAM)[b])
            ok = gap <= testing.BEAM_GAP_LIMIT
            print(f"transformer (c): source {b} first differs from the "
                  f"plain route at step {first}, top-candidate gap {gap:.6g}"
                  f" (limit {testing.BEAM_GAP_LIMIT:g}) "
                  f"{'ok' if ok else 'MISS'}", flush=True)
            check(ok, f"transformer (c): source {b}'s beams part from the "
                      f"plain route's at a gap of {gap}")
    check(bool((lens >= 1).all()) and paths.shape == (
        nb, testing.TRANSFORMER_BEAM, steps), "transformer (c): bad output")
    del model, rec
    torch.cuda.empty_cache()


# Phase 12: the conv slice (nn conv, pooling, the vision functionals),
# ResNet-50 and the SD UNet, trained at bench.py's configurations.
P12_WARMUP, P12_STEPS = 2, 5
RN_BATCH, RN_IMG, RN_CLASSES = 64, 224, 1000
UN_BATCH, UN_CTX_LEN = 8, 16
SD_BATCH, SD_CTX_LEN = 2, 77
# the conv step's device kernels -> group, first match wins (cuDNN's
# kernels name their pass: fprop, dgrad, wgrad, or their FFT stages; its
# layout transposes go with the convolutions; BatchNorm's and GroupNorm's
# statistics are
# the plain reductions); the optimizer's update is traced alone
_CONV_GROUPS = (("wgrad", "conv_wgrad"), ("dgrad", "conv_dgrad"),
                ("fprop", "conv_fwd"), ("convolve", "conv_fwd"),
                ("conv2d", "conv_fwd"), ("fft", "conv_fft"),
                ("nchwToNhwc", "conv_layout"),
                ("nhwcToNchw", "conv_layout"), ("gemm", "cublas"),
                ("nvjet", "cublas"), ("xmma", "cublas"),
                ("cutlass", "cublas"), ("reduce_kernel", "reduce"),
                ("softmax", "softmax"), (MARKER_KERNEL, "marker"))


# phase 12's traces lead with many short markers: late in the whole
# script a window has lost its first records on the H100, from 9 (the 8
# markers traced_device_ms leads with and a 20 ms spin) to at least 695
# (the step's first kernels with them), at every attempt
P12_MARKER_LEAD = 2048


def _marked(run):
    """`run` after P12_MARKER_LEAD marker kernels, then one closing
    marker, and the predicate that a trace lost nothing of `run`: its
    first and its last device kernel are markers (the leading markers
    are there to be dropped in place of the work)."""
    import torch
    from torch.autograd import DeviceType

    def marked():
        for _ in range(P12_MARKER_LEAD):
            torch.cuda._sleep(MARKER_CYCLES)
        run()
        torch.cuda._sleep(MARKER_CYCLES)

    def complete(prof):
        line = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        ok = (len(line) > 2 and MARKER_KERNEL in line[0][1]
              and MARKER_KERNEL in line[-1][1])
        if not ok:
            print(f"trace: {len(line)} device records, "
                  f"{sum(MARKER_KERNEL in n for _, n in line)} markers, "
                  f"first {line[0][1][:40] if line else None!r}, last "
                  f"{line[-1][1][:40] if line else None!r}", flush=True)
        return ok

    return marked, complete


def _step_fn(which, model):
    """bench.py's loss of `which` over `model`: cross-entropy of the
    logits (ResNet-50), MSE of the predicted noise (the UNets)."""
    from paddle_tpu_torch.nn import functional as F
    if which == "resnet50":
        return lambda x, y: F.cross_entropy(model(x), y)
    return lambda a, t, c, n: F.mse_loss(model(a, t, c), n)


def _conv_model(which, device, seed, B=None):
    """(model, step_fn, batch, images) of phase 12's configurations:
    "resnet50" (bench.py:422-431), "unet" (bench.py:432-451) or "sd15"
    (`unet_sd15()`), weights from a seeded generator on `device`, the
    batch (B samples, or the configuration's) from default_rng(0) in
    bench.py's order."""
    import numpy as np
    import torch

    from paddle_tpu_torch.models import unet as TU
    from paddle_tpu_torch.vision.models import resnet50

    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(device=device, generator=gen)
    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(device)

    if which == "resnet50":
        model = resnet50(num_classes=RN_CLASSES, **kw)
        B = B or RN_BATCH
        batch = (put(rng.standard_normal((B, 3, RN_IMG, RN_IMG)).astype(
            np.float32)), put(rng.integers(0, RN_CLASSES, (B,))))
        return model, _step_fn(which, model), batch, B
    if which == "unet":
        model = TU.UNet2DConditionModel(
            block_out_channels=(128, 256, 512, 512), cross_attention_dim=512,
            sample_size=32, **kw)
        B, L = B or UN_BATCH, UN_CTX_LEN
    else:
        model = TU.UNet2DConditionModel(TU.unet_sd15(), **kw)
        B, L = B or SD_BATCH, SD_CTX_LEN
    cfg = model.cfg
    sz = cfg.sample_size
    x = rng.standard_normal((B, cfg.in_channels, sz, sz)).astype(np.float32)
    t = rng.integers(0, 1000, (B,))
    ctx = rng.standard_normal((B, L, cfg.cross_attention_dim)).astype(
        np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    return (model, _step_fn(which, model),
            tuple(put(a) for a in (x, t, ctx, noise)), B)


def conv_phase(report, smi_line):
    """Phase 12 (module docstring): (a) ResNet-50 and (b) the UNet
    trained at bench.py's configurations, (c) a B = 2 step of each on
    the card against the CPU, (d) one SD 1.5 UNet step. cuDNN's TF32
    switch is set to its default (on) first: the conv functionals must
    keep f32 convolutions in f32 themselves."""
    import gc

    import torch
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    for which in ("resnet50", "unet"):
        conv_train(which, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
    for which in ("resnet50", "unet"):
        conv_card_cpu(which, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
    sd15_step(smi_line)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"conv phase: wall {time.perf_counter() - t0:.3f} s", flush=True)


def conv_train(which, smi_line):
    """(a) / (b): `which` through TrainStep with AdamW(1e-4, weight decay
    0.01), P12_WARMUP warm-up and P12_STEPS timed steps by CUDA events:
    step ms, images/s, MFU (`testing.forward_flops` x 3 over 989
    TFLOP/s; f32 with TF32 off caps it at 67 / 989), peak memory; one
    more step traced (forward and backward, then the update alone, each
    window held to its markers), its device ms by group and busy share.
    Every loss finite."""
    import math

    import torch

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step_fn, batch, images = _conv_model(which, "cuda", 0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    want = {"resnet50": testing.RESNET50_PARAMS,
            "unet": testing.BENCH_UNET_PARAMS}[which]
    check(n_params == want, f"conv {which}: {n_params} parameters, "
          f"expected {want}")
    opt = popt.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.01)
    step = TrainStep(model, opt, step_fn)
    shapes = " ".join(str(list(t.shape)) for t in batch)
    torch.cuda.synchronize()
    print(f"conv {which}: f32 built in {time.perf_counter() - t0:.3f} s, "
          f"{n_params} parameters, batch {shapes}", flush=True)
    model.eval()        # counting runs a forward: no BatchNorm update
    fwd = testing.forward_flops(
        model, *batch[:1 if which == "resnet50" else 3])
    model.train()
    losses = [step(*batch) for _ in range(P12_WARMUP)]
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(P12_STEPS + 1)]
    wall0 = time.perf_counter()
    events[0].record()
    for i in range(P12_STEPS):
        losses.append(step(*batch))
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - wall0
    losses = [float(x) for x in losses]
    mean_ms = events[0].elapsed_time(events[-1]) / P12_STEPS
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(P12_STEPS)]
    flops = 3 * fwd
    rate = flops / (mean_ms / 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"conv {which}: losses={[round(x, 6) for x in losses]} (first "
          f"{P12_WARMUP} warm-up)", flush=True)
    print(f"conv {which}: step_ms={mean_ms:.6g} per step "
          f"{[round(x, 4) for x in step_ms]} wall_per_step_ms="
          f"{1e3 * wall / P12_STEPS:.6g} images_per_s="
          f"{images / (mean_ms / 1e3):.6g} mfu="
          f"{rate / PEAK_FLOPS['bfloat16']:.6g} (forward products "
          f"{fwd:.6g} FLOP x 3 over 989 TFLOP/s; f32 "
          f"with TF32 off caps it at 0.0677) f32_rate_share="
          f"{rate / PEAK_FLOPS['float32']:.6g} (over 67 TFLOP/s) "
          f"peak_mem_gb={peak:.6g} [{smi_line}]", flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"a conv {which} training loss is not finite")

    # each window can run again (a trace that lost records is taken
    # again): the grads stay until both are traced
    fb, fb_done = _marked(lambda: step_fn(*batch).backward())
    prof_fb = device_trace(fb, fb_done)
    up, up_done = _marked(opt.step)
    prof_opt = device_trace(up, up_done)
    opt.clear_grad(set_to_zero=False)
    if not (fb_done(prof_fb) and up_done(prof_opt)):
        print(f"conv {which} profile: not measured (a trace lost its "
              f"markers)", flush=True)
    else:
        groups, others = _device_ms(prof_fb, _CONV_GROUPS, "elementwise")
        opt_groups, _ = _device_ms(prof_opt, ((MARKER_KERNEL, "marker"),),
                                   "adamw")
        groups.pop("marker", None)
        groups["adamw"] = opt_groups.get("adamw", 0.0)
        busy = sum(groups.values())
        parts = " ".join(f"{g}={groups.get(g, 0.0):.6g}" for g in (
            "conv_fwd", "conv_dgrad", "conv_wgrad", "conv_fft",
            "conv_layout", "cublas", "reduce", "softmax", "elementwise",
            "adamw"))
        print(f"conv {which} profile (device ms, one step): {parts} "
              f"total={busy:.6g} busy_share={busy / mean_ms:.4f} "
              f"[{smi_line}]", flush=True)
        top = sorted(others.items(), key=lambda kv: -kv[1])[:8]
        print(f"conv {which} profile, largest ungrouped kernels (ms): "
              + "; ".join(f"{k[:70]}={ms:.4g}" for k, ms in top),
              flush=True)
    del model, opt, step, batch, prof_fb, prof_opt


def _rel_l2(a, b):
    return ((a.double().cpu() - b.double().cpu()).norm()
            / b.double().cpu().norm().clamp_min(1e-30)).item()


def conv_card_cpu(which, smi_line):
    """(c): `which` built once on the CPU from a seeded generator at
    batch 2, copied to the card and to an f64 copy on the CPU; one
    training step on each. The loss and BatchNorm's running statistics
    after the step: card against CPU within testing's CARD_CPU_LOSS_RTOL
    and CARD_CPU_STAT_RTOL. Every parameter's grad (relative L2 a
    tensor): the card's against the f64 run within `testing.
    card_grad_limit` of the CPU's own f32 error there, and the card's
    against the CPU's within twice that."""
    import copy

    import torch

    from paddle_tpu_torch import testing

    def run(model, batch):
        model.train()
        loss = _step_fn(which, model)(*batch)
        loss.backward()
        grads = {n: p.grad.detach() for n, p in model.named_parameters()}
        stats = {n: b.detach() for n, b in model.named_buffers()}
        return float(loss.detach()), grads, stats

    cpu_model, _, cpu_batch, _ = _conv_model(which, "cpu", 1, B=2)
    card_model = copy.deepcopy(cpu_model).to("cuda")
    exact_model = copy.deepcopy(cpu_model).double()
    t0 = time.perf_counter()
    loss_c, grads_c, stats_c = run(cpu_model, cpu_batch)
    cpu_s = time.perf_counter() - t0
    _, grads_x, _ = run(exact_model, tuple(
        t.double() if t.is_floating_point() else t for t in cpu_batch))
    loss_g, grads_g, stats_g = run(card_model, tuple(
        t.to("cuda") for t in cpu_batch))
    torch.cuda.synchronize()

    def worst(errs):
        n = max(errs, key=errs.get)
        return n, errs[n]

    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    cpu_name, cpu_err = worst({n: _rel_l2(grads_c[n], grads_x[n])
                               for n in grads_x})
    card_name, card_err = worst({n: _rel_l2(grads_g[n], grads_x[n])
                                 for n in grads_x})
    pair_name, pair_err = worst({n: _rel_l2(grads_g[n], grads_c[n])
                                 for n in grads_c})
    limit = testing.card_grad_limit(cpu_err)
    stat = (worst({n: _rel_l2(stats_g[n], stats_c[n]) for n in stats_c})
            if stats_c else None)
    ok = (loss_err <= testing.CARD_CPU_LOSS_RTOL and card_err <= limit
          and pair_err <= 2 * limit
          and (stat is None or stat[1] <= testing.CARD_CPU_STAT_RTOL))
    stat_txt = ("no running statistics" if stat is None else
                f"running stats max rel L2 {stat[1]:.6g} at {stat[0]} "
                f"(limit {testing.CARD_CPU_STAT_RTOL:g})")
    print(f"conv (c) {which} card vs CPU, B = 2, one step: loss card "
          f"{loss_g:.8g} cpu {loss_c:.8g} rel_err={loss_err:.6g} (limit "
          f"{testing.CARD_CPU_LOSS_RTOL:g}); grads max rel L2 against the "
          f"f64 run: cpu {cpu_err:.6g} at {cpu_name}, card {card_err:.6g} "
          f"at {card_name} (limit {limit:.6g}); card against cpu "
          f"{pair_err:.6g} at {pair_name} (limit {2 * limit:.6g}); "
          f"{stat_txt}; CPU step {cpu_s:.3f} s {'ok' if ok else 'MISS'} "
          f"[{smi_line}]", flush=True)
    check(ok, f"conv (c) {which}: the card's step disagrees with the CPU's")
    del cpu_model, card_model, exact_model


def sd15_step(smi_line):
    """(d): `unet_sd15()` at its published width (859.5 M parameters),
    one AdamW training step at B = 2, latents [2, 4, 64, 64], context
    [2, 77, 768] (after one warm-up step): step ms by CUDA events, peak
    memory; the output and the loss finite."""
    import math

    import torch

    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.jit import TrainStep

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, step_fn, batch, _ = _conv_model("sd15", "cuda", 0)
    model.train()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == testing.SD15_UNET_PARAMS, f"conv (d): {n_params} "
          f"parameters, expected {testing.SD15_UNET_PARAMS}")
    opt = popt.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                     weight_decay=0.01)
    step = TrainStep(model, opt, step_fn)
    torch.cuda.synchronize()
    print(f"conv (d) sd15: built in {time.perf_counter() - t0:.3f} s, "
          f"{n_params} parameters, batch "
          f"{' '.join(str(list(t.shape)) for t in batch)}", flush=True)
    losses = [float(step(*batch))]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    losses.append(float(step(*batch)))
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    with torch.no_grad():
        out = model(*batch[:3])
    finite = bool(torch.isfinite(out).all())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"conv (d) sd15: losses={[round(x, 6) for x in losses]} (first "
          f"a warm-up) step_ms={ms:.6g} images_per_s="
          f"{SD_BATCH / (ms / 1e3):.6g} peak_mem_gb={peak:.6g} output "
          f"{list(out.shape)} finite={finite} [{smi_line}]", flush=True)
    check(finite and all(math.isfinite(x) for x in losses)
          and tuple(out.shape) == tuple(batch[0].shape),
          "conv (d): the SD 1.5 step is not finite or has the wrong shape")
    del model, opt, step, batch, out


def transformer_kernels(report, smi_line):
    """(d) the kernel entries at phase 11's shapes, f32: row 12's bias
    forward (with its dkv and dq held too) at the decode and encoder
    shapes of `testing.TRANSFORMER_BIAS_CASES`, and row 10's segment
    forward without ids at `testing.TRANSFORMER_SEG_CASE`, each against
    its plain version element by element, then timed by events and by
    the card's own time beside the plain version, SDPA with the same
    mask (the library call) and the bound."""
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa

    dt, it = torch.float32, 4
    for tag, kw in testing.TRANSFORMER_BIAS_CASES.items():
        c = testing.bias_case(**kw, dtype=dt, seed=6)
        q, k, v, do = c["q"], c["k"], c["v"], c["do"]
        B, Sq, hq, d = q.shape
        Sk = k.shape[1]
        shape = f" [{tag} B{B} Sq{Sq}/{Sk} H{hq} D{d} f32 source mask]"
        pairs, _ = testing.bias_flash_pairs(
            q, k, v, do, c["kind"], c["param"], c["R"], c["padding_mask"],
            c["causal"], c["scale"])
        err = compare("flash_attention_bias_fwd", "float32", pairs[:2], shape)
        compare("flash_attention_bias_dkv", "float32", pairs[3:], shape)
        compare("flash_attention_bias_dq", "float32", pairs[2:3], shape)
        del pairs
        a = kfa._bias_args(c["kind"], c["param"], c["R"], None, q.shape,
                           k.shape)
        plain = (c["kind"], c["param"], None, False, c["scale"], None, None)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return kfa.flash_attention_bias_fwd(q, k, v, a, False,
                                                c["scale"])

        # bound at 3xTF32 (f32-accurate products on the tensor cores,
        # as row 10's f32 kernels run them), the SIMT bound beside it:
        # this kernel runs on SIMT
        m = timed_3xtf32(
            "flash_attention_bias_fwd", err, kernel,
            lambda: kfa._biased_plain_fwd(q, k, v, *plain),
            nbytes=(q.numel() * 2 + k.numel() + v.numel()) * it
            + 4 * B * hq * Sq + c["param"].numel() * 4,
            flops=4 * B * hq * Sq * Sk * d,
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=c["param"]),
            iters=20, plain_iters=5, tag=shape)
        m["device_ms"] = traced_device_ms(kernel, kernel="flash_fwd_")
        m["library_device_ms"] = _library_device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=c["param"]))
        print(f"kernel flash_attention_bias_fwd f32{shape}: device_ms="
              f"{m['device_ms']:.6g} library_device_ms="
              f"{m['library_device_ms']} [{smi_line}]", flush=True)
        report["flash_attention_bias_fwd"][tag] = m
        del c, q, k, v, do, a, qt, kt, vt
    kw = testing.TRANSFORMER_SEG_CASE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((kw["B"], kw["Sq"], kw["h"], kw["d"]), generator=gen,
                    device="cuda")
    k, v = (torch.randn((kw["B"], kw["Sk"], kw["h"], kw["d"]), generator=gen,
                        device="cuda") for _ in range(2))
    scale = kw["d"] ** -0.5
    shape = (f" [transformer_decode_sq1 B{kw['B']} Sq{kw['Sq']}/{kw['Sk']}"
             f" H{kw['h']} D{kw['d']} f32 no ids]")
    err = compare("flash_attention_seg_fwd", "float32",
                  testing.seg_noid_pairs(q, k, v, scale), shape)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def seg_kernel():
        return kfa.flash_attention_seg_fwd(q, k, v, None, None, False, scale)

    m = timed_3xtf32(
        "flash_attention_seg_fwd", err, seg_kernel,
        lambda: kfa._plain(q, k, v, False, scale),
        nbytes=(q.numel() * 2 + k.numel() + v.numel()) * it
        + 4 * kw["B"] * kw["h"] * kw["Sq"],
        flops=4 * kw["B"] * kw["h"] * kw["Sq"] * kw["Sk"] * kw["d"],
        library=lambda: F.scaled_dot_product_attention(qt, kt, vt),
        iters=20, plain_iters=5, tag=shape)
    m["device_ms"] = traced_device_ms(seg_kernel, kernel="flash_fwd_")
    m["library_device_ms"] = _library_device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt))
    print(f"kernel flash_attention_seg_fwd f32{shape}: device_ms="
          f"{m['device_ms']:.6g} library_device_ms="
          f"{m['library_device_ms']} [{smi_line}]", flush=True)
    report["flash_attention_seg_fwd"]["transformer_decode_sq1"] = m


def _library_device_ms(fn, attempts=3):
    """`traced_device_ms` of a library call, whose kernels' names are the
    library's: a trace that holds none of its kernels (late in a long
    run the profiler has dropped every record of a window) is taken
    again; None ("not measured") when every attempt read nothing."""
    for _ in range(attempts):
        ms = traced_device_ms(fn)
        if ms > 0.0:
            return ms
    return None


def card_state():
    """The card's SM clock (MHz), temperature (C) and power draw (W) as
    nvidia-smi reads them now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    clock, temp, power = (float(x) for x in
                          smi.stdout.strip().splitlines()[0].split(","))
    return {"sm_clock_mhz": clock, "temp_c": temp, "power_w": power}


def host_us(fn, iters=100, rounds=5):
    """Host microseconds to enqueue one call of fn: `iters` calls with no
    synchronisation among them (the card runs behind; 100 launches stay
    well inside its launch queue), the least of `rounds` rounds."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / iters


def paged_times():
    """Rows 9 and 13 for the `paddle_tpu_torch` first on sys.path, bf16,
    by events, by the card's own time (`traced_device_ms`, each launch
    counted) and by the host's time to enqueue one wrapper call
    (`host_us`), each call on its own copy of the pools (`pool_copies`):
    paged decode attention at the bucketed engine's case and at
    generate's cache (`testing.PAGED_DECODE_CASES` "engine",
    "generate_cache"), ragged paged attention at each of
    `RAGGED_ROWS`, the `ROW_TILED` cases with row tiles where the
    checkout's wrapper takes them (keys `ragged_<tag>_*`, as the
    speculative engine launches them) and without (`*_without_row_tiles`;
    a checkout without row tiles has only these, under `ragged_<tag>_*`)."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import paged_attention as kpa
    from paddle_tpu_torch.kernels import ragged_paged_attention as krpa

    out = {}
    for tag in ("engine", "generate_cache"):
        ((_, args),) = testing.paged_decode_cases(torch.bfloat16,
                                                  tags=(tag,))
        call = paged_call(kpa, args)
        out[f"paged_decode_{tag}_ms"] = time_ms(call, 200)
        out[f"paged_decode_{tag}_device_ms"] = traced_device_ms(
            call, 40, kernel=PAGED_KERNEL)
        out[f"paged_decode_{tag}_host_us"] = host_us(call)
        del call, args
    gen = torch.Generator(device="cuda").manual_seed(1234)
    takes_flags = "row_tiles" in inspect.signature(
        krpa.ragged_paged_attention).parameters
    for tag, rows in RAGGED_ROWS.items():
        args, _ = ragged_case(torch, torch.bfloat16, gen, rows)
        flags = row_tiles_for(torch, tag, rows)
        # a checkout whose wrapper takes row tiles is timed with them
        # where the speculative engine passes them, and without
        ways = ([("", {"row_tiles": flags})] if flags is not None
                and takes_flags else [])
        ways.append(("_without_row_tiles" if ways else "", {}))
        for suffix, kw in ways:
            call = ragged_call(krpa, args, **kw)
            key = f"ragged_{tag}{suffix}"
            out[f"{key}_ms"] = time_ms(call, 100)
            out[f"{key}_device_ms"] = traced_device_ms(
                call, 40, kernel=RAGGED_KERNEL)
            out[f"{key}_host_us"] = host_us(call)
            del call
        del args
    torch.cuda.empty_cache()
    return out


def norm_times():
    """Rows 1 and 8 for the `paddle_tpu_torch` first on sys.path, each
    reading as `split_times` takes it (events ms, the card's own time with
    each trace held to its launches, the host's enqueue time of one
    wrapper call under `torch.no_grad`): rms_norm at the kernel phase's
    timed shapes, bf16; block_attention_stats at "sdpa_bias" (bf16 and
    f32), "alibi_7b" and the ring diagonal round [1, 4096, 32, 128] with
    the causal mask (built here: the parent's testing module has no such
    case), then the bf16 kernel at the ring round's grid walking 1, 16 and
    64 kv tiles (its cost a block and a tile). Uses only entry points the
    parent commit has."""
    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import block_attention as kba
    from paddle_tpu_torch.kernels import rms_norm as krn

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for rows, H, tag in ((128, 4096, "serving"), (4, 4096, "decode"),
                         (8192, 2048, "training"),
                         (8192, 4096, "training_7b")):
        x = torch.randn((rows, H), generator=gen, device="cuda").bfloat16()
        w = 1 + 0.1 * torch.randn((H,), generator=gen, device="cuda")

        def call():
            return krn.rms_norm(x, w, 1e-5)

        with torch.no_grad():
            out[f"rms_{tag}_ms"] = time_ms(call, 100)
            out[f"rms_{tag}_device_ms"] = traced_device_ms(
                call, 40, kernel=RMS_KERNEL)
            out[f"rms_{tag}_host_us"] = host_us(call)
        del x, w
    bf, f32 = torch.bfloat16, torch.float32
    for tag, dt in (("sdpa_bias", bf), ("alibi_7b", bf), ("ring_7b", bf),
                    ("sdpa_bias", f32)):
        if tag == "ring_7b":
            q, k, v = (torch.randn((1, 4096, 32, 128), generator=gen,
                                   device="cuda").to(dt) for _ in range(3))
            mask = torch.ones((4096, 4096), dtype=torch.bool,
                              device="cuda").tril()
            scale, bias = 128 ** -0.5, None
        else:
            q, k, v, mask, scale, bias = testing.stats_case(
                **testing.STATS_CASES[tag], dtype=dt)

        def call():
            return kba.block_attention_fwd(q, k, v, mask, scale, bias)

        key = f"stats_{tag}{'' if dt == bf else '_f32'}"
        with torch.no_grad():
            out[f"{key}_ms"] = time_ms(call, 20)
            out[f"{key}_device_ms"] = traced_device_ms(call, 10,
                                                       kernel=STATS_KERNEL)
            out[f"{key}_host_us"] = host_us(call, iters=20)
        del q, k, v, mask, bias
        torch.cuda.empty_cache()
    # the bf16 kernel's cost a block and a kv tile: the ring round's 1024
    # blocks (32 bands x 32 heads) walking 1, 16 and 64 tiles of 64 keys,
    # no mask, no bias
    q = torch.randn((1, 4096, 32, 128), generator=gen, device="cuda").to(bf)
    for sk in (64, 1024, 4096):
        k, v = (torch.randn((1, sk, 32, 128), generator=gen,
                            device="cuda").to(bf) for _ in range(2))
        out[f"stats_walk_sk{sk}_device_ms"] = traced_device_ms(
            lambda: kba.block_attention_fwd(q, k, v, None, 0.088), 10,
            kernel=STATS_KERNEL)
    return out


def w8a16_times():
    """Row 14 for the `paddle_tpu_torch` first on sys.path, bf16, at
    llama_7b's quantized products (`testing.W8A16_SHAPES`) at 4 and 128
    rows: events, the card's own time (`traced_device_ms`) and the host's
    enqueue of one wrapper call (`host_us`). Uses only entry points the
    parent commit has."""
    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import weight_only_linear as kwol
    out = {}
    for name, (K, N, gu) in testing.W8A16_SHAPES.items():
        for M in (4, 128):
            a, q, s = testing.w8a16_case(M, K, N, seed=M)

            def call(a=a, q=q, s=s, gu=gu):
                return kwol.weight_only_linear(a, q, s, swiglu=gu)

            key = f"w8a16_{name}_{M}"
            out[f"{key}_ms"] = time_ms(call, 50)
            out[f"{key}_device_ms"] = traced_device_ms(call,
                                                       kernel="w8a16_kernel")
            out[f"{key}_host_us"] = host_us(call)
    return out


# Row 14's diagnostic builds (`w8a16_diagnose`): each is the kernel's own
# source with the named pieces cut out by text, so the kernel keeps no
# switches. "no_products": the wgmma products skipped (dequant and loads
# kept); "consumers_only": the producer idle and the consumers never
# waiting for a stage (dequant and products on whatever shared memory
# holds); "consumers_only_no_products": both; "loads_only": the
# consumers release each stage as it lands.
_W8A16_CUTS = {
    "mma": ("      Elem<T>::mma(acc, f[kk], hw::desc_sw128(at + kk * 16, 16, "
            "1024),\n                   !first || kk > 0);\n", ""),
    "producer": ("      produce<T, GU, NP>(&map_a, &map_q, p, smem, full, "
                 "empty, KT);\n", "      ;\n"),
    "full_wait": ("    hw::mbar_wait(&full[st], ph);\n    const float* sc =",
                  "    const float* sc ="),
    "release": ("      if (kk == 3 && !first && lane == 0) "
                "hw::mbar_arrive(&empty[st_prev]);\n", ""),
    "release_end": ("      hw::fence_regs(acc);\n      if (lane == 0) "
                    "hw::mbar_arrive(&empty[st_prev]);\n",
                    "      hw::fence_regs(acc);\n"),
    "early_release": ("    hw::mbar_wait(&full[st], ph);\n    const float* sc =",
                      "    hw::mbar_wait(&full[st], ph);\n"
                      "    if (lane == 0) hw::mbar_arrive(&empty[st]);\n"
                      "    if (++st == G::STAGES) {\n      st = 0;\n"
                      "      ph ^= 1;\n    }\n    return;\n"
                      "    const float* sc ="),
}
_W8A16_VARIANTS = {
    "kernel": (),
    "no_products": ("mma",),
    "consumers_only": ("producer", "full_wait", "release", "release_end"),
    "consumers_only_no_products": ("producer", "full_wait", "release",
                                   "release_end", "mma"),
    "loads_only": ("early_release", "release_end"),
}


def w8a16_diagnose():
    """Where row 14's time goes at llama_7b's products, 4 and 128 rows:
    the card's own time (`traced_device_ms`) of the kernel and of each
    diagnostic build of `_W8A16_VARIANTS`, built with nvcc from a copy of
    csrc/ with the cuts applied and loaded in place of the package's
    library. A cut whose text is missing from the source fails the run
    (the kernel changed: update `_W8A16_CUTS`)."""
    import ctypes
    import tempfile

    import torch

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import weight_only_linear as kwol

    _, _, smi_line = device_phase()
    src_dir = _build.CSRC_DIR
    with open(os.path.join(src_dir, "weight_only_linear.cu")) as f:
        source = f.read()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="w8a16_diag_", dir=_build.BUILD_DIR)
    for name in os.listdir(src_dir):
        if name.endswith(".cuh"):
            shutil.copy(os.path.join(src_dir, name), work)
    procs = {}
    for variant, cuts in _W8A16_VARIANTS.items():
        text = source
        for cut in cuts:
            old, new = _W8A16_CUTS[cut]
            check(old in text, f"w8a16_diagnose: the cut {cut!r} is not in "
                               f"csrc/weight_only_linear.cu")
            text = text.replace(old, new)
        cu = os.path.join(work, f"{variant}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(work, f"{variant}.so")
        procs[variant] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for variant, (so, proc) in procs.items():
        out = proc.communicate()[0].decode(errors="replace")
        check(proc.returncode == 0, f"w8a16_diagnose: {variant} did not "
                                    f"build:\n{out[-2000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            if "weight_only" in fn:
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
        libs[variant] = lib
    cases = {(name, M): (*testing.w8a16_case(M, K, N, seed=M), gu)
             for name, (K, N, gu) in testing.W8A16_SHAPES.items()
             for M in (4, 128)}
    out = {}
    saved = _build._lib
    try:
        for variant, lib in libs.items():
            _build._lib = lib
            for (name, M), (a, q, s_, gu) in cases.items():
                def call(a=a, q=q, s_=s_, gu=gu):
                    return kwol.weight_only_linear(a, q, s_, swiglu=gu)
                key = f"{variant}_{name}_{M}_device_ms"
                out[key] = traced_device_ms(call, kernel="w8a16_kernel")
                print(f"w8a16 diagnose {variant} {name} at {M} rows: "
                      f"device_ms={out[key]:.6g} [{smi_line}]", flush=True)
    finally:
        _build._lib = saved
        shutil.rmtree(work, ignore_errors=True)
    return out


def route_times(only=None):
    """Rows 1 and 8 alone with only="norm" (`norm_times`), row 14 alone
    with only="w8a16" (`w8a16_times`). Otherwise rows
    9 and 13 (`paged_times`; alone with only="paged"), then rows
    2-4's, row 10's and row 12's times for the `paddle_tpu_torch`
    first on sys.path, bf16 on one card, as one JSON object: the 1B and 7B
    flash forward and backward kernels (causal [4, 2048, 16 and 32, 128];
    the backward with its delta pre-pass); flash_
    attention_biased with causal alibi at the same shape and sdpa with the
    float [16, 1, 1, 512] mask at bert width (the BERT lengths), forward
    and forward + backward; the alibi route's forward + backward peak
    memory above its inputs; rows 10-11's segment route (sdpa with the
    boolean mask at bert width, forward and forward + backward;
    flash_attn_unpadded on the same batch, forward + backward; the
    forward kernel at BERT's shape in bf16 and f32 and at the packed
    causal 8192 tokens; dkv + dq in bf16 at both; the packed causal
    route's forward + backward; dkv + dq at BERT's shape in f32 too; the
    f32 one-length forward and backward at ERNIE's shape and at
    llama_1b's causal [4, 2048, 16, 128], each beside SDPA in f32 with
    TF32 off: its forward, and its backward alone over a retained
    forward) and the bert_base f32 forward
    on the BERT phase's batch; swiglu at 128 and 4 rows of llama_7b's
    width, swiglu, swiglu_bwd_da and swiglu_bwd_dw at 8192 rows of
    llama_7b's and llama_1b's widths, then swiglu at 128 and 4 rows again,
    each small-row reading beside `card_state`. Uses only entry points
    the parent commit has."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_tpu_torch import testing
    from paddle_tpu_torch.kernels import flash_attention as kfa
    from paddle_tpu_torch.kernels import swiglu as ksw
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.nn import functional as TF

    torch.backends.cuda.matmul.allow_tf32 = False
    if only == "norm":
        return norm_times()
    if only == "w8a16":
        return w8a16_times()
    out = paged_times()
    if only == "paged":
        return out
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def fwd_bwd(fn, inputs, do):
        leaves = [t.detach().requires_grad_() for t in inputs]
        fn(*leaves).backward(do)

    scale = 128 ** -0.5
    # row 10 at llama_1b's training shape, then llama_7b's (whose inputs
    # the alibi route below reuses)
    for tag, H in (("1b", 16), ("7b", 32)):
        q, k, v, do = (rand(4, 2048, H, 128) for _ in range(4))
        out[f"flash_fwd_{tag}_ms"] = time_ms(
            lambda: kfa.flash_attention_fwd(q, k, v, True, scale), 20)
        o, lse = kfa.flash_attention_fwd(q, k, v, True, scale)
        out[f"flash_bwd_{tag}_ms"] = time_ms(
            lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, True,
                                            scale), 10)
        del o, lse
    slopes = 2.0 ** (-8.0 * torch.arange(1, 33, device="cuda") / 32)

    def alibi(a, b, c):
        return kfa.flash_attention_biased(a, b, c, "alibi", slopes,
                                          causal=True)

    out["alibi_fwd_ms"] = time_ms(lambda: alibi(q, k, v), 5, warmup=1)
    out["alibi_fwd_bwd_ms"] = time_ms(lambda: fwd_bwd(alibi, (q, k, v), do),
                                      3, warmup=1)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd(alibi, (q, k, v), do)
    torch.cuda.synchronize()
    out["alibi_peak_gb"] = (torch.cuda.max_memory_allocated()
                            - resident) / 1e9
    del q, k, v, do
    lengths = np.random.default_rng(0).integers(64, 513, 16)
    lengths[0] = 512
    valid = (torch.arange(512, device="cuda")[None, :]
             < torch.tensor(lengths, device="cuda")[:, None])
    fmask = torch.where(valid, 0.0, -1e4).float()[:, None, None, :]
    q, k, v, do = (rand(16, 512, 12, 64) for _ in range(4))

    def sdpa_float(a, b, c):
        return TF.scaled_dot_product_attention(a, b, c, attn_mask=fmask)

    out["float_mask_fwd_ms"] = time_ms(lambda: sdpa_float(q, k, v), 10)
    out["float_mask_fwd_bwd_ms"] = time_ms(
        lambda: fwd_bwd(sdpa_float, (q, k, v), do), 5)
    # rows 10-11's segment forward: sdpa with the boolean mask on the same
    # batch (the route's forward), the forward kernel alone at BERT's
    # padded [16, 512, 12, 64] in bf16 and f32 and at the packed causal
    # 8192 tokens of llama_7b width, then the bert_base f32 forward
    bmask = valid[:, None, None, :]

    def sdpa_bool(a, b, c):
        return TF.scaled_dot_product_attention(a, b, c, attn_mask=bmask)

    out["bool_mask_fwd_ms"] = time_ms(lambda: sdpa_bool(q, k, v), 10)
    out["bool_mask_fwd_bwd_ms"] = time_ms(
        lambda: fwd_bwd(sdpa_bool, (q, k, v), do), 5)
    cu = torch.tensor([0] + [int(n) for n in lengths],
                      device="cuda").cumsum(0).to(torch.int32)

    def unpadded(a, b, c):
        return TF.flash_attn_unpadded(a, b, c, cu, cu, 512, 512,
                                      64 ** -0.5)[0]

    packed_in = [t[valid] for t in (q, k, v, do)]
    out["unpadded_fwd_bwd_ms"] = time_ms(
        lambda: fwd_bwd(unpadded, packed_in[:3], packed_in[3]), 5)
    del q, k, v, do, packed_in
    # the segment kernels: the forward at BERT's shape in bf16 and f32 and
    # at the packed causal 8192 tokens; dkv + dq (one call each, over the
    # forward's lse and the delta pre-pass's D) at each
    for tag, dt, dn in (("bert", torch.bfloat16, "bf16"),
                        ("bert", torch.float32, "f32"),
                        ("packed_7b", torch.bfloat16, "bf16")):
        kw = testing.ATTN_SEG_CASES[tag]
        q, k, v, do, sq, skv = testing.attn_seg_case(**kw, dtype=dt)
        c, sc = kw["causal"], q.shape[-1] ** -0.5
        out[f"seg_fwd_{tag}_{dn}_ms"] = time_ms(
            lambda: kfa.flash_attention_seg_fwd(q, k, v, sq, skv, c, sc), 20)
        o, lse = kfa.flash_attention_seg_fwd(q, k, v, sq, skv, c, sc)
        args = (q, k, v, do, lse, kfa.flash_attention_delta(o, do), sq,
                skv, c, sc)

        def dkv_dq():
            kfa.flash_attention_seg_dkv(*args)
            kfa.flash_attention_seg_dq(*args)

        out[f"seg_dkv_dq_{tag}_{dn}_ms"] = time_ms(dkv_dq, 10)
        del o, lse, args, q, k, v, do, sq, skv
    # the f32 one-length route at ERNIE's [16, 512, 12, 64], full, and at
    # llama_1b's [4, 2048, 16, 128], causal: the forward and the backward
    # (with its delta pre-pass), then SDPA in f32 on the same inputs: its
    # forward, and its backward alone over a retained forward
    for tag, shape, c in (("ernie", (16, 512, 12, 64), False),
                          ("1b", (4, 2048, 16, 128), True)):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        sc = shape[-1] ** -0.5
        out[f"{tag}_f32_fwd_ms"] = time_ms(
            lambda: kfa.flash_attention_fwd(q, k, v, c, sc), 10)
        o, lse = kfa.flash_attention_fwd(q, k, v, c, sc)
        out[f"{tag}_f32_bwd_ms"] = time_ms(
            lambda: kfa.flash_attention_bwd(q, k, v, o, lse, do, c, sc), 5)
        qt, kt, vt, do_t = (t.transpose(1, 2) for t in (q, k, v, do))
        out[f"{tag}_f32_sdpa_fwd_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=c),
            10)
        leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]
        o_l = F.scaled_dot_product_attention(*leaves, is_causal=c)
        out[f"{tag}_f32_sdpa_bwd_ms"] = time_ms(
            lambda: torch.autograd.grad(o_l, leaves, do_t,
                                        retain_graph=True), 5)
        del q, k, v, do, o, lse, qt, kt, vt, do_t, leaves, o_l
    # the packed causal route through flash_attn_unpadded at llama_7b
    # width, forward and backward
    lengths7 = testing.packed_lengths()
    T = sum(lengths7)
    cu7 = torch.tensor([0] + lengths7, device="cuda").cumsum(0).to(
        torch.int32)
    q, k, v, do = (rand(T, 32, 128) for _ in range(4))

    def packed(a, b, c):
        return TF.flash_attn_unpadded(a, b, c, cu7, cu7, max(lengths7),
                                      max(lengths7), 128 ** -0.5,
                                      causal=True)[0]

    out["packed_causal_fwd_bwd_ms"] = time_ms(
        lambda: fwd_bwd(packed, (q, k, v), do), 3, warmup=1)
    del q, k, v, do
    cfg = TB.bert_base()
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (16, 512))).to("cuda")
    model = TB.BertForMaskedLM(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(0)).eval()
    with torch.no_grad():
        out["bert_f32_forward_ms"] = time_ms(
            lambda: model(ids, torch.zeros_like(ids), valid.long()), 5,
            warmup=2)
    del model, ids
    torch.cuda.empty_cache()
    # rows 2-4: the SwiGLU forward at the serving and decode rows of
    # llama_7b (bytes-bound), the forward and backward launches at the
    # training slices' shapes (8192 rows), then the serving and decode
    # forward again: the card's clock after a long run of dense products
    # moves the bytes-bound times, so both readings carry its state
    wgu = (0.02 * rand(4096, 2 * 11008)).bfloat16()

    def serving_rows(after):
        for T in (128, 4):
            a = rand(T, 4096)
            out[f"swiglu_fwd_7b_T{T}{after}_ms"] = time_ms(
                lambda: ksw.swiglu(a, wgu, use_kernel=True), 50)
        out.update({f"{k}{after}": v for k, v in card_state().items()})

    serving_rows("")
    for tag, H, M in (("7b", 4096, 11008), ("1b", 2048, 5504)):
        a, dout = rand(8192, H), rand(8192, M)
        wgu = (0.02 * rand(H, 2 * M)).bfloat16()
        out[f"swiglu_fwd_{tag}_ms"] = time_ms(
            lambda: ksw.swiglu(a, wgu, use_kernel=True), 10)
        _, dgu = ksw.swiglu_bwd_da(a, wgu, dout)
        out[f"swiglu_bwd_da_{tag}_ms"] = time_ms(
            lambda: ksw.swiglu_bwd_da(a, wgu, dout), 10)
        out[f"swiglu_bwd_dw_{tag}_ms"] = time_ms(
            lambda: ksw.swiglu_bwd_dw(a, dgu), 10)
        del a, dout, dgu
    wgu = (0.02 * rand(4096, 2 * 11008)).bfloat16()
    serving_rows("_after_gemms")
    return out


def ab_main(parent, only=None):
    """`route_times` for the parent checkout and this one in fresh
    processes, in the order parent, change, change, parent; prints each
    run and then, per metric, the parent's and the change's readings.
    only="paged": rows 9 and 13 alone; only="norm": rows 1 and 8 alone;
    only="w8a16": row 14 alone
    (`norm_times`)."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = os.path.abspath(parent)
    _, _, smi_line = device_phase()
    runs = []
    for who, root in (("parent", parent), ("change", here),
                      ("change", here), ("parent", parent)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--route-times",
             root, *([only] if only else [])], capture_output=True,
            text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:] + res.stderr[-3000:], file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"ab {who} ({root}): {json.dumps(got)}", flush=True)
        runs.append((who, got))
    for key in dict.fromkeys(k for _, r in runs for k in r):
        by = {w: [r.get(key) for x, r in runs if x == w]
              for w in ("parent", "change")}
        print(f"ab {key}: parent {by['parent']} change {by['change']} "
              f"[{smi_line}]", flush=True)
    return 0


def main():
    # the 7B training phase holds ~65 GB of the card's 80: let the
    # allocator grow segments instead of fragmenting fixed ones
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        name, count, smi_line = device_phase()
        t0 = time.perf_counter()
        from paddle_tpu_torch.kernels import _build
        _build.library()
        print(f"build: kernels built and loaded in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        report = {}
        kernel_phase(report)
        transformer_kernels(report, smi_line)
        model, prompts, max_new = slice_phase(report, smi_line)
        # the ragged engine and its captured steps go first (the capture
        # hook makes a reference cycle), then the model before training
        import gc

        import torch
        gc.collect()
        torch.cuda.empty_cache()
        generate_phase(report, model, smi_line)
        bucketed_phase(report, model, prompts, max_new, smi_line)
        slo_phase(report, model, prompts, max_new, smi_line)
        trace_phase(report, model, prompts, max_new, smi_line)
        # last on this model: (d) overwrites its weights
        int8_phase(report, model, prompts, max_new, smi_line)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        plain_1b_ms = training_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        train7b_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        bert_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        encoder_train_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        optimizer_phase(report, plain_1b_ms, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        surface_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        transformer_phase(report, smi_line)
        gc.collect()
        torch.cuda.empty_cache()
        conv_phase(report, smi_line)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": [report[k] for k in SOURCES]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--route-times":
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        import paddle_tpu_torch
        check(paddle_tpu_torch.__file__.startswith(
            os.path.abspath(sys.argv[2])), "route_times imported another "
            "checkout's package")
        print(json.dumps(route_times(*sys.argv[3:])))
        sys.exit(0)
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--ab":
        sys.exit(ab_main(*sys.argv[2:]))
    if len(sys.argv) == 2 and sys.argv[1] == "--conv":
        # phase 12 alone (no kernel of the port runs there)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        try:
            conv_phase({}, device_phase()[2])
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
            sys.exit(1)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--w8a16-diagnose":
        try:
            print(json.dumps(w8a16_diagnose()))
        except SmokeFailure as e:
            print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
            sys.exit(1)
        sys.exit(0)
    sys.exit(main())
