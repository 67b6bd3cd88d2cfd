"""Continuous-batching LLM serving over the paged KV cache, both
scheduler regimes of the reference, with the prefix cache (counterpart
of paddle_tpu/inference/serving.py).

A global KV PAGE POOL `[L, kvh, n_pages, page, d]` plus a host-side
free-list allocator and per-slot block tables: KV memory is
proportional to live tokens, not batch * max_seq. Two regimes,
selected by `ragged=` or FLAGS_ragged_attention (default on):

* chunked prefill ("ragged"): admission splits prompts into
  KV-budgeted prefill CHUNKS (`max_chunk_tokens` per tick) packed into
  the SAME step as the active decode rows: one ragged attention launch
  per layer per tick, rows padded to one fixed count (`_T_pack`). The
  prefix cache maps each fully-written prompt PAGE (content-hash chain)
  to its physical page, so a later prompt with the same leading pages
  attaches them (refcount++) and prefills only the rest.
* bucketed (`ragged=False` / FLAGS_ragged_attention=0): each admission
  round prefills whole prompts, batched per length bucket
  (`prefill_buckets`, k padded to a power of two), writes their KV into
  their pages, and every tick then runs ONE decode step for all active
  slots through the paged decode kernel. The prefix cache is off here,
  as in the reference.

Both regimes preempt the latest-admitted sequence on pool exhaustion
(recompute-style resume).

Self-speculative decoding (`speculative=` / FLAGS_speculative, default
on with FLAGS_speculative_draft_tokens = 4 drafts, as in the reference;
ragged regime, greedy only): an n-gram prompt-lookup drafter
(`_ngram_propose`) proposes up to k continuation tokens per decode slot
from the request's own prompt and output. They ride the decode row as
extra rows of the same ragged step (q_len = 1 + k), funded only from the
tick's leftover `max_chunk_tokens` budget and never from the pool's last
free page, so `_T_pack` stays the one padded shape. Greedy verification
commits the longest agreeing prefix plus the bonus token, exactly the
tokens the non-speculative engine would produce one tick at a time;
rejected rows roll back by truncating the slot's length, and pages
wholly past it return through the refcounted free. Each slot halves its
draft length on low acceptance and doubles it back after
`spec_hysteresis` ticks of full acceptance. On the card every row of a
decode or verify entry attends on a tile of its own
(`ragged_paged_attention(row_tiles=)`) and the verify logits are K
products of the last-row lm-head shape, so a verify row is bitwise the
decode row it stands for. FLAGS_speculative=0 (or `max_draft_tokens=0`)
is the kill switch: the step runs exactly as without speculation.

SLO layer (`slo=` / FLAGS_serving_slo, default on as in the reference;
`=0` is the kill switch: the FIFO engine, the same admissions, victims,
packing and step outputs): `GenerationRequest.priority` (higher wins)
and `deadline_s` (from arrival) order the wait queue by (priority,
earliest deadline), stable within equal keys; preemption never evicts a
higher-priority page holder for a lower one; an expired request fails
fast (`deadline_missed`, DeadlineExceeded in its error) and gives back
its slot and pages. `max_queue_tokens` bounds the queue: `add_request`
raises QueueFull with a `retry_after_s` hint from the tick throughput,
and `shed_patience` admission-starved ticks shed the lowest-priority,
most-slack waiter. Under pool pressure (`degrade_high_water`) the
ragged chunk budget halves down to `min_chunk_tokens`, and regrows
after `degrade_hysteresis` calm ticks (`_T_pack` does not change: only
the packing does). A tick that raises fails ONE request (the latest
admission) and the engine keeps serving; a row whose consumed logits
are not finite (a per-row flag the step computes and returns in the
same device-to-host copy as the tokens) fails exactly its request, and
the tick is discarded before any slot state advanced, the sampling
generator rewound with it. The fault points are
`utils.fault_injection`'s `serving.*`; `tick_timeout_s` arms a private
`distributed.watchdog.CommWatchdog` around each tick; the `serving.*`
counters, gauges and histograms record while `observability` is armed;
SLO-armed engines publish `health_snapshot()` through
`observability.export`'s health registry (`serving_health`).

Request tracing (`request_trace=` / FLAGS_request_trace, default on as
in the reference; `=0` is the kill switch: tokens, ticks and packed rows
bitwise as without it): every request gets a `RequestTrace`
(observability/reqtrace.py) at `add_request` under its `trace_id`
(minted unless the caller set one), carrying its event timeline
(arrival, admitted / resumed, prefill chunks, first token, drafts,
preemption, prefix reuse, the terminal event) and its attribution
ledger: each tick, every request that played a role is charged the span
since its last charge to that role (prefill_compute, decode_compute,
draft_overhead for a tick whose drafts were all refuted, page_wait while
parked), waits are charged to queue_wait or preempted, and each terminal
path settles the rest, so `sum(buckets) == wall`. The settled buckets go
into `serving.attribution_seconds{bucket}` with the trace id as the
exemplar. Each step's launches run inside `observability.device_events.
execution` ("serving.prefill", "serving.ragged_step", "serving.decode"),
closed before the step's read-back, so the CUDA event that ends the step
has completed once the read-back returns.

Differences from the reference, by design:
* the KV pools are torch tensors updated IN PLACE by index writes (the
  reference donates its pools to the compiled step instead); a
  discarded tick's writes stay, as the reference keeps its discarded
  step's pools, and the retry rewrites the same positions;
* the steps run eagerly on `device` (no jit, no compile cache); sampling
  draws from an explicit `torch.Generator` on the engine's device;
* the SLO layer's isolation boundary lets a kernel's or the card's own
  error through (`kernels._build.is_device_fault`: a build, load or
  launch failure, a CUDA runtime error, device memory exhausted): it
  raises out of `step()` and fails no request, where the reference
  quarantines whatever a tick raises;
* weight-only int8 (`quantize="int8"`, the reference's PTQ absmax rule,
  `quantize_state_int8`) keeps every quantized projection as an
  (int8, scale) `QuantWeight` and runs each product through the W8A16
  kernel (`kernels/weight_only_linear.py`): the dequant happens in the
  kernel's operand read, where the reference dequantizes the state in
  the step's trace and leaves the fusion to XLA. No dequantized weight
  is stored; on the CPU the plain route dequantizes in the reference's
  float order, so the tokens are the reference's.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework import core as _core
from ..framework.core import resolve_device
from ..kernels import _build
from ..kernels import weight_only_linear as _kwol
from ..kernels.ragged_paged_attention import _size_class
from ..models import llama as L
from ..observability import device_events as _devev
from ..observability import metrics as _metrics
from ..observability import reqtrace as _rtrace
from ..utils.fault_injection import fault_point
from .router import RETRY_AFTER_CEILING_S
from .router import chain_key as _chain_key

__all__ = ["GenerationRequest", "ContinuousBatchingEngine", "PagePool",
           "DeadlineExceeded", "QueueFull", "quantize_state_int8",
           "serving_health"]

_TTFT = _metrics.histogram(
    "serving.ttft_seconds",
    "request arrival to first generated token (time-to-first-token)")
_TPOT = _metrics.histogram(
    "serving.tpot_seconds",
    "mean per-output-token latency after the first token")
_KV_PAGES = _metrics.gauge(
    "serving.kv_pages_in_use",
    "allocated (non-free, non-scratch) pages in the KV page pool")
_PREEMPTS = _metrics.counter(
    "serving.preemptions_total",
    "recompute-style preemptions forced by KV pool pressure")
_PACKED = _metrics.histogram(
    "serving.packed_tokens_per_tick",
    "ragged rows (prefill-chunk + decode) packed into one mixed step",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0))
_DEADLINE_MISSES = _metrics.counter(
    "serving.deadline_misses_total",
    "requests failed fast with DeadlineExceeded (waiting or in-flight)")
_SHEDS = _metrics.counter(
    "serving.sheds_total",
    "waiting requests shed under sustained admission starvation")
_QUARANTINES = _metrics.counter(
    "serving.quarantines_total",
    "requests failed individually by tick-fault / non-finite isolation")
_QUEUE_DEPTH = _metrics.gauge(
    "serving.queue_depth", "requests waiting for admission (per tick)")
_DEGRADED = _metrics.gauge(
    "serving.degraded",
    "1 while adaptive degradation holds the effective prefill chunk "
    "budget below max_chunk_tokens")
_PREFIX_HITS = _metrics.counter(
    "serving.prefix_hits_total",
    "admissions that attached at least one cached prefix page")
_PREFIX_MISSES = _metrics.counter(
    "serving.prefix_misses_total",
    "admissions that found no cached prefix page")
_PREFIX_REUSED = _metrics.counter(
    "serving.prefix_pages_reused_total",
    "KV pages attached from the prefix cache instead of prefilled")
_PREFIX_RATIO = _metrics.gauge(
    "serving.prefix_reuse_ratio",
    "cumulative cacheable-prompt-pages served from the prefix cache "
    "(reused / seen)")
_SPEC_DRAFTED = _metrics.counter(
    "serving.spec_drafted_total",
    "draft tokens proposed by the n-gram prompt-lookup drafter")
_SPEC_ACCEPTED = _metrics.counter(
    "serving.spec_accepted_total",
    "draft tokens confirmed by greedy multi-row verification")
_SPEC_RATE = _metrics.gauge(
    "serving.spec_acceptance_rate",
    "cumulative draft acceptance rate (accepted / drafted) across the "
    "engine lifetime; per-request rates live on GenerationRequest")
_CACHE_AWARE = _metrics.counter(
    "serving.cache_aware_admits_total",
    "admissions reordered ahead of FIFO because their prompt prefix "
    "was hot in the prefix cache")
_ATTR = _metrics.histogram(
    "serving.attribution_seconds",
    "per-request wall decomposed into the request-trace attribution "
    "buckets (label bucket=queue_wait|prefill_compute|decode_compute|"
    "preempted|page_wait|draft_overhead|failover|stream_write); per "
    "request, sum over buckets == wall by construction")


class DeadlineExceeded(RuntimeError):
    """A request's deadline_s passed before it finished; the engine
    failed it fast (terminal status 'deadline_missed') and reclaimed its
    slot and pages."""


class QueueFull(RuntimeError):
    """add_request rejected at submit: the bounded wait queue
    (max_queue_tokens) is full. `retry_after_s` estimates when enough
    queue will have drained, from the engine's tick throughput; the
    gateway sends it as a 429's Retry-After."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


# ---------------- weight-only int8 PTQ ------------------------------------

def quantize_state_int8(state: Dict[str, torch.Tensor], min_size=4096):
    """Per-output-channel absmax int8 quantization of the 2-D floating
    weights with at least `min_size` elements whose names hold neither
    "embed" nor "norm" (the reference's choice, serving.py:240-260:
    norm scales are 1-D, embedding rows are gathered, not multiplied;
    the lm head is quantized). Quantized entries become `QuantWeight`
    (int8 [K, N], f32 scale [1, N]) pairs, by
    `quantization.comm.channelwise_absmax_int8` along axis 0."""
    from ..quantization import comm as _qcomm
    out = {}
    for k, v in state.items():
        if (isinstance(v, torch.Tensor) and v.dim() == 2
                and v.is_floating_point() and v.numel() >= min_size
                and "embed" not in k and "norm" not in k):
            out[k] = _kwol.QuantWeight(
                *_qcomm.channelwise_absmax_int8(v, axis=0))
        else:
            out[k] = v
    return out


def _dequant_state(state, dtype):
    """Each (int8, scale) entry as a `dtype` weight (the reference's
    in-trace dequant, serving.py:263-268): what a full-precision engine
    runs to reproduce the int8 engine's products."""
    from ..quantization import comm as _qcomm
    return {k: (_qcomm.dequantize_channelwise(v[0], v[1], dtype)
                if isinstance(v, tuple) else v)
            for k, v in state.items()}


# ---------------- requests -------------------------------------------------

@dataclass
class GenerationRequest:
    """One decode job. SLO fields (read only while the engine's SLO
    layer is armed): `priority`, higher wins admission and retention,
    equal priorities keep FIFO order; `deadline_s`, seconds from arrival
    after which the request fails fast with DeadlineExceeded. `status`
    tracks the lifecycle: queued -> running -> served / shed /
    deadline_missed / failed / cancelled; `error` carries the terminal
    error text for the non-served outcomes."""
    prompt: List[int]
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    request_id: Optional[int] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    # filled by the engine
    output: List[int] = field(default_factory=list)
    arrived_s: float = 0.0
    finished_s: Optional[float] = None
    first_token_s: Optional[float] = None
    status: str = "queued"
    error: Optional[str] = None
    # speculative decoding: draft tokens this request's slot proposed
    # and had confirmed
    spec_drafted: int = 0
    spec_accepted: int = 0
    # cache-aware admission: how many times a hotter-prefix waiter was
    # admitted ahead of this one (bounded by cache_jump_limit)
    admit_bypassed: int = 0
    # request tracing: the trace id (the gateway honours or mints it; the
    # engine mints one when it is None), seconds spent on failed hops
    # before this engine saw the request (preloaded into the ledger's
    # `failover` bucket and its wall), and the engine-attached
    # RequestTrace (None with tracing off)
    trace_id: Optional[str] = None
    failover_preload_s: float = 0.0
    trace: Optional[object] = field(default=None, repr=False)

    @property
    def done(self) -> bool:
        return self.finished_s is not None

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute perf_counter deadline, or None (no deadline)."""
        if self.deadline_s is None:
            return None
        return self.arrived_s + float(self.deadline_s)


class _Slot:
    __slots__ = ("req", "length", "produced", "last_token", "admit_seq",
                 "pending", "prefix_tokens", "cache_upto", "cache_key",
                 "spec_k", "spec_calm")

    def __init__(self):
        self.req: Optional[GenerationRequest] = None
        self.length = 0
        self.produced = 0
        self.last_token = 0
        self.admit_seq = -1
        # effective-prompt tokens not yet in KV
        self.pending: List[int] = []
        # prefix cache: the effective prompt at admission, how many of
        # its pages were offered to the index, and the chain key so far
        self.prefix_tokens: List[int] = []
        self.cache_upto = 0
        self.cache_key = b""
        # speculative decoding: the slot's current draft-length cap
        # (adaptive) and its count of full-acceptance ticks since the cap
        # last moved
        self.spec_k = 0
        self.spec_calm = 0

    @property
    def free(self):
        return self.req is None


# ---------------- page pool ------------------------------------------------

class PagePool:
    """Host-side free-list allocator over the global KV page pool. Page
    0 is reserved as a scratch page (padding rows write there; never
    allocated). Every allocated page carries a slot-holder refcount;
    `free` returns a page to the free list only when its last holder
    releases it and no attached prefix cache indexes it (then it stays
    idle-cached, reclaimable on demand, counted by `n_free`)."""

    def __init__(self, n_pages: int, page_size: int = 16):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is scratch)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free = list(range(self.n_pages - 1, 0, -1))  # pop() -> low ids
        self._refs: Dict[int, int] = {}
        self._cache = None

    def attach_cache(self, cache) -> None:
        self._cache = cache

    @property
    def n_free(self) -> int:
        n = len(self._free)
        if self._cache is not None:
            n += self._cache.evictable_count()
        return n

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None. Shortfalls first reclaim idle-cached pages
        (refcount-0 LRU) from the attached prefix cache."""
        fault_point("serving.page_alloc")
        if n > len(self._free) and self._cache is not None:
            self._cache.evict(n - len(self._free))
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            r = self._refs.get(p, 1) - 1
            if r > 0:
                self._refs[p] = r
                continue
            self._refs.pop(p, None)
            if self._cache is not None and self._cache.owns(p):
                continue
            self._free.append(p)

    def share(self, pages: List[int]) -> None:
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1

    def release_unindexed(self, page: int) -> None:
        if self._refs.get(page, 0) == 0:
            self._free.append(page)


# ---------------- prefix cache ---------------------------------------------


class _PrefixEntry:
    __slots__ = ("key", "page", "parent", "children", "last_use")

    def __init__(self, key: bytes, page: int, parent: bytes):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: set = set()
        self.last_use = 0


class _PrefixCache:
    """Content-hash chain index of fully-written prompt pages over a
    PagePool. Each entry maps chain_key(parent_key, page_tokens) to the
    physical page holding those tokens' KV; a lookup walks the prompt
    page by page and stops at the first miss. Pages are shared at full-
    page granularity only, so a shared page is never written again.
    Eviction is refcount-aware LRU, leaves first, on demand from
    `PagePool.alloc`; a running sequence's pages are never reclaimed."""

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page = int(page_size)
        self.entries: Dict[bytes, _PrefixEntry] = {}
        self.by_page: Dict[int, bytes] = {}
        self._root_children: set = set()
        self._clock = 0
        # bumped only when entries are DROPPED (probe-memo invalidation)
        self.epoch = 0
        self.hits = 0
        self.misses = 0
        self.pages_reused = 0
        self.pages_seen = 0
        self.evictions = 0
        self._heat_memo: Tuple[Optional[tuple], Dict[str, int]] = (None, {})
        pool.attach_cache(self)

    def _key(self, parent: bytes, toks: List[int]) -> bytes:
        return _chain_key(parent, toks)

    def owns(self, page: int) -> bool:
        return page in self.by_page

    def evictable_count(self) -> int:
        return sum(1 for p in self.by_page if self.pool.refcount(p) == 0)

    def lookup(self, eff: List[int]) -> Tuple[List[int], bytes]:
        """Longest cached full-page prefix of `eff`: increfs and returns
        (page ids, chain key up to them). At least one trailing token
        always stays uncached so the slot has a query row."""
        self._clock += 1
        n = (len(eff) - 1) // self.page
        self.pages_seen += n
        key = b""
        pages: List[int] = []
        for j in range(n):
            nxt = self._key(key, eff[j * self.page:(j + 1) * self.page])
            e = self.entries.get(nxt)
            if e is None:
                break
            e.last_use = self._clock
            key = nxt
            pages.append(e.page)
        if pages:
            self.pool.share(pages)
            self.hits += 1
            self.pages_reused += len(pages)
            _PREFIX_HITS.inc()
            _PREFIX_REUSED.inc(len(pages))
        else:
            self.misses += 1
            _PREFIX_MISSES.inc()
        if self.pages_seen:
            _PREFIX_RATIO.set(self.pages_reused / self.pages_seen)
        return pages, key

    def probe(self, eff: List[int]) -> int:
        """Side-effect-free longest-cached-prefix page count."""
        n = (len(eff) - 1) // self.page
        key = b""
        pages = 0
        for j in range(n):
            nxt = self._key(key, eff[j * self.page:(j + 1) * self.page])
            if nxt not in self.entries:
                break
            key = nxt
            pages += 1
        return pages

    def insert(self, parent: bytes, toks: List[int], page: int) -> bytes:
        """Offer one fully-written page; first writer wins. Returns the
        chain key the caller threads through successive offers."""
        key = self._key(parent, toks)
        if key in self.entries:
            return key
        e = _PrefixEntry(key, page, parent)
        self._clock += 1
        e.last_use = self._clock
        self.entries[key] = e
        self.by_page[page] = key
        if parent:
            pe = self.entries.get(parent)
            if pe is not None:
                pe.children.add(key)
        else:
            self._root_children.add(key)
        return key

    def evict(self, need: int) -> int:
        """Reclaim up to `need` idle-cached (refcount-0) pages, leaves
        first (LRU among leaves), else a ref-0 inner entry with its now
        unreachable subtree."""
        fault_point("serving.prefix_evict")
        freed = 0
        while freed < need:
            cands = [e for e in self.entries.values()
                     if self.pool.refcount(e.page) == 0]
            if not cands:
                break
            leaves = [e for e in cands
                      if not any(k in self.entries for k in e.children)]
            victim = min(leaves or cands, key=lambda e: e.last_use)
            freed += self._drop_subtree(victim)
        return freed

    def _drop_subtree(self, entry: _PrefixEntry) -> int:
        parent = self.entries.get(entry.parent)
        if parent is not None:
            parent.children.discard(entry.key)
        self._root_children.discard(entry.key)
        self.epoch += 1
        freed = 0
        stack = [entry]
        while stack:
            e = stack.pop()
            self.entries.pop(e.key, None)
            self.by_page.pop(e.page, None)
            self.evictions += 1
            if self.pool.refcount(e.page) == 0:
                self.pool.release_unindexed(e.page)
                freed += 1
            stack.extend(self.entries[k] for k in e.children
                         if k in self.entries)
        return freed

    def heat(self, cap: int = 64) -> Dict[str, int]:
        """Chain-HEAD key (hex) -> cached pages under that head (the
        fleet router's affinity oracle), memoized on (epoch, count)."""
        key = (self.epoch, len(self.entries))
        memo_key, memo = self._heat_memo
        if memo_key == key:
            return memo
        out: Dict[str, int] = {}
        for head in self._root_children:
            pages = 0
            stack = [head]
            while stack:
                e = self.entries.get(stack.pop())
                if e is None:
                    continue
                pages += 1
                stack.extend(e.children)
            out[head.hex()] = pages
        if len(out) > cap:
            out = dict(sorted(out.items(), key=lambda kv: -kv[1])[:cap])
        self._heat_memo = (key, out)
        return out

    def stats(self) -> dict:
        return {"entries": len(self.entries),
                "hits": self.hits, "misses": self.misses,
                "pages_reused": self.pages_reused,
                "pages_seen": self.pages_seen,
                "evictions": self.evictions,
                "reuse_ratio": round(
                    self.pages_reused / self.pages_seen, 4)
                if self.pages_seen else 0.0}


# ---------------- self-speculative drafting ---------------------------------


def _ngram_propose(ctx: List[int], k: int, max_ngram: int,
                   min_ngram: int) -> List[int]:
    """Prompt-lookup drafting (the self-speculative n-gram rule): match
    the last n tokens of `ctx` (prompt + generated history) against the
    earlier context, longest n first, and propose up to k continuation
    tokens from the MOST RECENT occurrence, preferring the most recent
    one with a full k-token continuation. No draft model: the bet is that
    output quotes its input or repeats itself, and exact verification
    makes a wrong bet cost only the tick's spare rows."""
    L = len(ctx)
    if k <= 0 or L < min_ngram + 1:
        return []
    arr = np.asarray(ctx, np.int64)
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pat = arr[L - n:]
        # windows over ctx[:-1], so every match has >= 1 continuation
        # token; a match overlapping the suffix is how a period-p
        # repetition extends itself
        win = np.lib.stride_tricks.sliding_window_view(arr[:L - 1], n)
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if hits.size:
            # a match butting up against the end of history truncates
            # the proposal: prefer the newest one with k tokens after it
            full = hits[hits + n + k <= L]
            j = int(full[-1]) if full.size else int(hits[-1])
            return [int(t) for t in arr[j + n:j + n + k]]
    return []


# ---------------- engine ---------------------------------------------------

def _next_tokens(logits, greedy, gen):
    """logits [B, V] f32 -> i32[B]: argmax, or one draw per row from
    softmax(logits) with `gen`. A row with a non-finite logit draws from
    zeros instead (multinomial refuses NaN, and on the card asserts):
    the SLO layer discards that row's token, and every row still takes
    one draw, so the other rows' draws do not move."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    finite = torch.isfinite(logits).all(dim=-1, keepdim=True)
    logits = torch.where(finite, logits, 0.0)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=gen)[:, 0].to(torch.int32)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the paged KV pool.

    model: LlamaForCausalLM. max_batch = decode slots; max_seq = per-
    slot KV capacity (page-aligned); ragged=None follows
    FLAGS_ragged_attention (chunked prefill; False is the bucketed
    regime, whose prompts prefill per `prefill_buckets` length bucket);
    max_chunk_tokens bounds the prefill tokens packed into one ragged
    tick; prefix_cache=None follows FLAGS_prefix_cache (ragged regime
    only). device: where the step runs (default `cuda`;
    with no card this raises unless device='cpu' is passed).

    speculative=None follows FLAGS_speculative (ragged + greedy only):
    self-speculative n-gram drafting with multi-token verification rows;
    max_draft_tokens caps the per-slot draft length (None =
    FLAGS_speculative_draft_tokens), spec_min_ngram / spec_max_ngram
    bound the prompt-lookup match, and spec_hysteresis is the count of
    full-acceptance ticks before a backed-off slot doubles its draft
    length again.

    SLO layer (slo=None follows FLAGS_serving_slo; module docstring):
    max_queue_tokens bounds the wait queue (None = unbounded, shedding
    off); shed_patience = consecutive admission-starved ticks before one
    waiter is shed; min_chunk_tokens is the degradation floor and
    degrade_high_water / degrade_low_water / degrade_hysteresis the pool
    utilization thresholds and calm-tick count steering the effective
    chunk budget; tick_timeout_s arms a per-tick watchdog (None = off).

    request_trace=None follows FLAGS_request_trace (module docstring);
    quantize="int8" serves weight-only int8 projections
    (`quantize_state_int8`, the W8A16 kernel; on the card the model is
    bf16 or f16); any other value but None raises NotImplementedError."""

    def __init__(self, model, max_batch: int = 4, max_seq: int = 256,
                 prefill_buckets=(32, 64, 128, 256), quantize=None,
                 greedy: bool = True, seed: int = 0,
                 total_pages: Optional[int] = None, page_size: int = 16,
                 max_chunk_tokens: int = 64, ragged: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 speculative: Optional[bool] = None,
                 max_draft_tokens: Optional[int] = None,
                 spec_min_ngram: int = 1, spec_max_ngram: int = 3,
                 spec_hysteresis: int = 4, cache_jump_limit: int = 8,
                 slo: Optional[bool] = None,
                 max_queue_tokens: Optional[int] = None,
                 shed_patience: int = 8, min_chunk_tokens: int = 8,
                 degrade_high_water: float = 0.85,
                 degrade_low_water: float = 0.5,
                 degrade_hysteresis: int = 16,
                 tick_timeout_s: Optional[float] = None,
                 request_trace: Optional[bool] = None,
                 device=None):
        _core.check_env_flags("ContinuousBatchingEngine")
        self.device = resolve_device(device)
        self._ragged = (_core.get_bool_flag("FLAGS_ragged_attention", True)
                        if ragged is None else bool(ragged))
        if quantize not in (None, "int8"):
            raise NotImplementedError(
                f"quantize={quantize!r} is not ported (int8 is)")
        if quantize == "int8" and self.device.type == "cuda":
            wdt = model.state_dict()["model.embed_tokens"].dtype
            if wdt not in (torch.bfloat16, torch.float16):
                raise NotImplementedError(
                    f"quantize='int8' on the card needs a bf16 or f16 "
                    f"model (the W8A16 kernel's activations), not {wdt}")
        if int(max_chunk_tokens) < 1:
            raise ValueError(
                f"max_chunk_tokens must be >= 1, got {max_chunk_tokens}")
        self.cfg = model.cfg
        self.B = int(max_batch)
        page = int(page_size)
        self.page = page
        self.S = int(-(-max_seq // page) * page)     # page-aligned
        self.ppmax = self.S // page
        # the full slot capacity is always a bucket, so any prompt <=
        # max_seq has one
        self.buckets = tuple(sorted(
            {b for b in prefill_buckets if b < self.S} | {self.S}))
        self.greedy = greedy
        raw = {k: v.detach().to(self.device)
               for k, v in model.state_dict().items()}
        self.dtype = raw["model.embed_tokens"].dtype
        self._quantized = quantize == "int8"
        self.state = quantize_state_int8(raw) if self._quantized else raw
        del raw
        self._wls = L._gather_layer_weights(self.state, self.cfg)
        cfg = self.cfg
        L_, kvh, d = cfg.num_hidden_layers, cfg.kv_heads, cfg.head_dim
        n_pages = int(total_pages) if total_pages else self.B * self.ppmax + 1
        self.pool = PagePool(n_pages, page)
        self.k_pool = torch.zeros((L_, kvh, n_pages, page, d),
                                  dtype=self.dtype, device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.page_table = np.zeros((self.B, self.ppmax), np.int32)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self.slots = [_Slot() for _ in range(self.B)]
        self.waiting: List[GenerationRequest] = []
        self.finished: List[GenerationRequest] = []
        self._next_id = 0
        self._admit_seq = 0
        self.preemptions = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.max_chunk_tokens = int(max_chunk_tokens)
        # ONE padded row count: decode slots + the chunk budget, rounded
        # to the kernel's power-of-two size class
        self._T_pack = _size_class(self.B + self.max_chunk_tokens)
        self.last_packed_tokens = 0
        self.prefill_tokens_total = 0
        self.model_steps = 0             # ragged steps run (one per tick
        #                                  that scheduled any row)
        self.decode_steps = 0            # bucketed decode steps run
        self.prefill_calls: Dict[Tuple[int, int], int] = {}  # (bucket, k)
        # prefix caching: ragged regime only — the bucketed prefill
        # computes whole prompts in one batched call, so there is no
        # seam to skip cached pages through
        pfx = (_core.get_bool_flag("FLAGS_prefix_cache", True)
               if prefix_cache is None else bool(prefix_cache))
        self._pcache = (_PrefixCache(self.pool, page)
                        if pfx and self._ragged else None)
        # self-speculative decoding: ragged + GREEDY only (verification
        # is greedy-argmax agreement, so a sampling engine never
        # speculates); FLAGS_speculative=0 or max_draft_tokens=0 is the
        # kill switch. Draft rows ride the max_chunk_tokens budget, so
        # _T_pack stays the one padded shape.
        spec = (_core.get_bool_flag("FLAGS_speculative", True)
                if speculative is None else bool(speculative))
        if max_draft_tokens is None:
            max_draft_tokens = int(_core.get_flag(
                "FLAGS_speculative_draft_tokens", 4) or 0)
        self.max_draft_tokens = max(int(max_draft_tokens), 0)
        self._spec = (spec and self._ragged and self.greedy
                      and self.max_draft_tokens > 0)
        self.spec_min_ngram = max(int(spec_min_ngram), 1)
        self.spec_max_ngram = max(int(spec_max_ngram), self.spec_min_ngram)
        self.spec_hysteresis = max(int(spec_hysteresis), 1)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.cache_jump_limit = max(int(cache_jump_limit), 1)
        self.cache_aware_admits = 0
        self._probe_memo: Dict[int, Tuple[int, int, int]] = {}
        self.ticks = 0
        # the serving step, called through the engine (a test may wrap it)
        self._ragged_step = L._ragged_step_paged
        # -- the SLO layer. Disarmed, every branch it guards is skipped
        # and the engine is the FIFO scheduler (kill-switch parity).
        self._slo = (_core.get_bool_flag("FLAGS_serving_slo", True)
                     if slo is None else bool(slo))
        self.max_queue_tokens = (None if max_queue_tokens is None
                                 else int(max_queue_tokens))
        self.shed_patience = max(int(shed_patience), 1)
        self.min_chunk_tokens = max(
            1, min(int(min_chunk_tokens), self.max_chunk_tokens))
        self.degrade_high_water = float(degrade_high_water)
        self.degrade_low_water = float(degrade_low_water)
        self.degrade_hysteresis = max(int(degrade_hysteresis), 1)
        self._eff_chunk = self.max_chunk_tokens
        self._calm_ticks = 0
        self._pressure_ticks = 0
        self._admitted_this_tick = False
        self._tick_failures = 0
        self._last_tick_s: Optional[float] = None
        self._tokens_per_s = 0.0          # EMA over ticks (retry hints)
        self.deadline_misses = 0
        self.sheds = 0
        self.quarantines = 0
        self._wd = None
        if self._slo and tick_timeout_s is not None:
            # a private watchdog: a wedged tick warns, naming
            # 'serving.tick', and the engine itself is left alone
            from ..distributed.watchdog import CommWatchdog
            self._wd = CommWatchdog(timeout=float(tick_timeout_s),
                                    on_timeout="warn")
        if self._slo:
            _register_health_engine(self)
        # -- request tracing, resolved once; every hook guards on the
        # bool, and no scheduling decision reads it
        self._rtrace = (_core.get_bool_flag("FLAGS_request_trace", True)
                        if request_trace is None else bool(request_trace))
        # request_id -> (req, bucket) for the requests that did something
        # this tick; charged into each request's ledger at the end of step()
        self._tick_roles: Dict[int, tuple] = {}

    # -- memory accounting ---------------------------------------------------

    @property
    def kv_cache_bytes(self) -> int:
        return int(self.k_pool.nbytes + self.v_pool.nbytes)

    # -- the model step ------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _ragged_fn(self):
        """(state, toks[T], k_pool, v_pool, page_ids[T], offs[T], pos[T],
        page_table, q_start[B], q_len[B], kv_len[B], produce[B], prev[B],
        generator) -> (next[B], k_pool, v_pool) — ONE mixed prefill +
        decode step; next[b] comes from sequence b's last packed row and
        stays prev[b] where produce[b] is False. Speculation armed, the
        13th argument is `verify[B]` (the decode and verify entries)
        instead of prev, and next is the argmax of each sequence's last
        min(K, q_len) rows, [B, K] right-aligned (K = max_draft_tokens
        + 1). SLO layer armed, the step also returns `ok[B]` after next:
        whether every logit of the rows the host consumes is finite
        (a producing row; under speculation every row of a decode or
        verify entry and only the last row of a producing chunk)."""
        cfg, greedy, wls, slo = self.cfg, self.greedy, self._wls, self._slo
        step_ragged = self._ragged_step
        if self._spec:
            K = self.max_draft_tokens + 1

            def rstep_spec(state, toks, k_pool, v_pool, page_ids, offs,
                           pos, page_table, q_start, q_len, kv_len,
                           produce, verify, gen):
                lg, k_pool, v_pool = step_ragged(
                    state, cfg, toks, pos, k_pool, v_pool, page_ids, offs,
                    page_table, q_start, q_len, kv_len, verify_rows=K,
                    wls=wls, row_tiles=verify)
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)   # [B, K]
                if not slo:
                    return nxt, k_pool, v_pool
                j = torch.arange(K, device=lg.device)[None, :]
                in_window = ((j >= K - torch.clamp(q_len, max=K)[:, None])
                             & (q_len > 0)[:, None])
                consumed = torch.where(
                    verify[:, None], in_window,
                    (produce & ~verify)[:, None] & (j == K - 1))
                poison = ~torch.isfinite(lg).all(dim=-1) & consumed
                return nxt, ~poison.any(dim=-1), k_pool, v_pool

            return rstep_spec

        def rstep(state, toks, k_pool, v_pool, page_ids, offs, pos,
                  page_table, q_start, q_len, kv_len, produce, prev, gen):
            lg, k_pool, v_pool = step_ragged(
                state, cfg, toks, pos, k_pool, v_pool, page_ids, offs,
                page_table, q_start, q_len, kv_len, wls=wls)
            nxt = torch.where(produce, _next_tokens(lg, greedy, gen), prev)
            if not slo:
                return nxt, k_pool, v_pool
            # mid-prompt and idle rows are exempt
            ok = torch.isfinite(lg).all(dim=-1) | ~produce
            return nxt, ok, k_pool, v_pool

        return rstep

    def _read_back(self, nxt, ok):
        """next tokens and the SLO layer's ok flags on the host in ONE
        device-to-host copy: (next as numpy, ok as a numpy bool[B])."""
        B = self.B
        both = torch.cat([nxt.reshape(B, -1).to(torch.int32),
                          torch.as_tensor(ok, device=nxt.device)
                          .reshape(B, 1).to(torch.int32)], dim=1)
        both = both.cpu().numpy()
        tok = both[:, :-1]
        return (tok if nxt.dim() > 1 else tok[:, 0]), both[:, -1] != 0

    def _write_fn(self, k_new, v_new, page_ids, offs):
        """k_new/v_new [L, N, kvh, d] into the pools at (page_ids[N],
        offs[N]): one in-place index write per pool (the reference's
        compiled scatter). Padding positions carry page id 0 (scratch)."""
        pid, off = page_ids.long(), offs.long()
        self.k_pool[:, :, pid, off] = k_new.transpose(1, 2).to(self.dtype)
        self.v_pool[:, :, pid, off] = v_new.transpose(1, 2).to(self.dtype)

    # -- scheduler ----------------------------------------------------------

    def check_request(self, req: GenerationRequest) -> None:
        """Reject a prompt that can never fit (ValueError). Reads only the
        engine's fixed sizes, so any thread may call it."""
        need = -(-len(req.prompt) // self.page)
        if need > self.pool.n_pages - 1:
            raise ValueError(
                f"prompt needs {need} pages but the pool only has "
                f"{self.pool.n_pages - 1} allocatable pages")
        if len(req.prompt) > self.S:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds max_seq {self.S}")

    def add_request(self, req: GenerationRequest):
        """Queue a request. An impossible prompt raises ValueError; under
        the SLO layer a full queue (max_queue_tokens) raises QueueFull
        with a retry hint, and the request never enters the queue."""
        self.check_request(req)
        if self._slo:
            fault_point("serving.admit")
            if self.max_queue_tokens is not None:
                queued = self._queued_tokens()
                if queued + len(req.prompt) > self.max_queue_tokens:
                    retry = self._retry_after_hint(
                        queued + len(req.prompt) - self.max_queue_tokens)
                    raise QueueFull(
                        f"wait queue full ({queued} queued tokens, "
                        f"bound {self.max_queue_tokens}); retry in "
                        f"~{retry:.2f}s", retry_after_s=retry)
        if req.request_id is None:
            req.request_id = self._next_id
            self._next_id += 1
        req.arrived_s = time.perf_counter()
        req.status = "queued"
        if self._rtrace:
            tr = _rtrace.new_trace(req.trace_id, now=req.arrived_s)
            req.trace = tr
            req.trace_id = tr.trace_id
            if req.failover_preload_s > 0:
                tr.preload("failover", req.failover_preload_s)
            tr.event("arrival", prompt_tokens=len(req.prompt),
                     priority=req.priority)
        self.waiting.append(req)
        return req.request_id

    def _queued_tokens(self) -> int:
        return sum(len(r.prompt) + len(r.output) for r in self.waiting)

    def _retry_after_hint(self, overflow_tokens: int) -> float:
        """Seconds until ~overflow_tokens of queue should have drained,
        from the tick throughput's EMA; 1.0 on a cold engine or a
        near-zero EMA, at most RETRY_AFTER_CEILING_S."""
        if self.ticks > 0 and self._tokens_per_s > 1e-6:
            return min(max(overflow_tokens / self._tokens_per_s, 0.01),
                       RETRY_AFTER_CEILING_S)
        return 1.0

    def _free_slot_pages(self, i):
        if self.slot_pages[i]:
            self.pool.free(self.slot_pages[i])
            self.slot_pages[i] = []
        self.page_table[i, :] = 0

    def _preempt(self, i):
        """Recompute-preemption: release slot i's pages and push its
        request back to the FRONT of the wait queue; re-admission
        prefills prompt+output so decoding resumes where it stopped."""
        slot = self.slots[i]
        req = slot.req
        slot.req = None
        slot.pending = []
        self._free_slot_pages(i)
        req.status = "queued"
        if self._rtrace and req.trace is not None:
            tr = req.trace
            # the span up to now goes to the last charged bucket (the
            # reference drops this tick's role first); from here to
            # re-admission the request waits as `preempted`
            self._tick_roles.pop(req.request_id, None)
            tr.charge(tr.pending_bucket)
            tr.pending_bucket = "preempted"
            tr.event("preempted")
        self.waiting.insert(0, req)
        self.preemptions += 1
        _PREEMPTS.inc()

    def _oversized(self, eff_len: int) -> bool:
        return (-(-eff_len // self.page) > self.pool.n_pages - 1
                or eff_len > self.S)

    def _trace_settle(self, req, event: str, **fields):
        """Terminal trace bookkeeping: charge the span from the last mark
        to finished_s to the request's role this tick (else its pending
        bucket), record the terminal event (through the sink too), and
        observe each bucket into serving.attribution_seconds with the
        trace id as the exemplar."""
        if not self._rtrace or req.trace is None:
            return
        tr = req.trace
        if tr.status is not None:
            return                       # already terminal
        now = (req.finished_s if req.finished_s is not None
               else time.perf_counter())
        ent = self._tick_roles.pop(req.request_id, None)
        tr.charge(ent[1] if ent is not None else tr.pending_bucket, now)
        if req.error:
            fields.setdefault("error", req.error)
        tr.finish(req.status, event, now=now, **fields)
        for name, secs in tr.buckets.items():
            _ATTR.observe(secs, exemplar=tr.trace_id, bucket=name)

    def _trace_charge_tick(self):
        """End of a tick: every request that played a role in it is
        charged the span since its last mark to that role (a request
        already terminal is skipped)."""
        if not self._tick_roles:
            return
        now = time.perf_counter()
        for req, bucket in self._tick_roles.values():
            tr = req.trace
            if tr is None or tr.status is not None:
                continue
            tr.charge(bucket, now)
        self._tick_roles.clear()

    def _fail_request(self, req):
        req.status = "failed"
        req.error = "oversized resume stream"
        req.finished_s = time.perf_counter()
        self._trace_settle(req, "failed")
        self.finished.append(req)

    def _note_first_token(self, req):
        if len(req.output) == 1 and req.first_token_s is None:
            req.first_token_s = time.perf_counter()
            ttft = req.first_token_s - req.arrived_s
            # exemplar=None leaves the histogram cells as without tracing
            ex = (req.trace_id
                  if self._rtrace and req.trace is not None else None)
            if self._slo:
                _TTFT.observe(ttft, exemplar=ex, priority=str(req.priority))
            else:
                _TTFT.observe(ttft, exemplar=ex)
            if ex is not None:
                req.trace.event("first_token", ttft_s=ttft)

    def _maybe_finish(self, i):
        slot = self.slots[i]
        req = slot.req
        if req is None:
            return
        eos_hit = (req.eos_token_id is not None
                   and req.output and req.output[-1] == req.eos_token_id)
        cap = min(self.S, (self.pool.n_pages - 1) * self.page)
        full = slot.length + 1 > cap - 1
        if slot.produced >= req.max_new_tokens or eos_hit or full:
            req.finished_s = time.perf_counter()
            req.status = "served"
            if req.first_token_s is not None and len(req.output) > 1:
                tpot = ((req.finished_s - req.first_token_s)
                        / (len(req.output) - 1))
                ex = (req.trace_id
                      if self._rtrace and req.trace is not None else None)
                if self._slo:
                    _TPOT.observe(tpot, exemplar=ex,
                                  priority=str(req.priority))
                else:
                    _TPOT.observe(tpot, exemplar=ex)
            self._trace_settle(req, "finished", n_tokens=len(req.output))
            self.finished.append(req)
            slot.req = None
            slot.pending = []
            self._free_slot_pages(i)

    def _grow(self):
        """Every active DECODE-phase slot whose next token crosses a page
        boundary gets a fresh page; on a dry pool preempt the latest-
        admitted OTHER page-holding slot (or this one) and retry."""
        for i, slot in enumerate(self.slots):
            if slot.free or slot.pending:
                continue
            while slot.req is not None:
                have = len(self.slot_pages[i]) * self.page
                if slot.length < have:
                    break
                pg = self.pool.alloc(1)
                if pg is not None:
                    n = len(self.slot_pages[i])
                    self.slot_pages[i].append(pg[0])
                    self.page_table[i, n] = pg[0]
                    break
                victims = [j for j, s in enumerate(self.slots)
                           if j != i and not s.free and self.slot_pages[j]]
                if self._slo:
                    # never evict a higher-priority page holder for a
                    # lower-priority grower; among the eligible take the
                    # lowest priority, latest admission
                    mine = slot.req.priority
                    victims = [j for j in victims
                               if self.slots[j].req.priority <= mine]
                    if victims:
                        self._preempt(max(
                            victims,
                            key=lambda j: (-self.slots[j].req.priority,
                                           self.slots[j].admit_seq)))
                    else:
                        self._preempt(i)     # everything else outranks it
                elif victims:
                    self._preempt(max(
                        victims, key=lambda j: self.slots[j].admit_seq))
                else:
                    self._preempt(i)

    # -- bucketed scheduler ---------------------------------------------------

    def _bucket(self, T):
        for b in self.buckets:
            if T <= b:
                return b
        raise ValueError(f"prompt length {T} exceeds max_seq {self.S}")

    def _admit(self):
        """Move waiting requests into free slots, allocating ONLY the
        pages the prompts need; requests stay queued while the pool has
        no room. Same-bucket admissions of one round share ONE batched
        prefill and ONE pool write. Rounds repeat while they admit, so
        pages freed by a request that FINISHES at admission serve later
        waiters in the same tick."""
        while self._admit_round():
            pass

    def _admit_round(self) -> bool:
        free_slots = [i for i, s in enumerate(self.slots) if s.free]
        picked = []          # (slot_idx, req, eff, T, need, pages)
        while self.waiting and free_slots:
            req = self.waiting[0]
            # re-admission after preemption resumes from prompt + output
            eff = list(req.prompt) + list(req.output)
            T = len(eff)
            need = -(-T // self.page)
            if self._oversized(T):
                self.waiting.pop(0)
                self._fail_request(req)
                continue
            pages = self.pool.alloc(need)
            if pages is None:
                break                    # pool full: stay waiting
            self.waiting.pop(0)
            picked.append((free_slots.pop(0), req, eff, T, need, pages))
        if not picked:
            return False
        by_bucket: Dict[int, list] = {}
        for item in picked:
            by_bucket.setdefault(self._bucket(item[3]), []).append(item)
        for bucket, group in by_bucket.items():
            self._admit_group(bucket, group)
        return True

    def _admit_group(self, bucket, group):
        """One batched prefill + one pool write for a same-bucket
        admission group; k pads up to a power of two, as the reference
        does to bound its compile cache (padding rows write the scratch
        page)."""
        n = len(group)
        k = 1
        while k < n:
            k *= 2
        ids = np.zeros((k, bucket), np.int32)
        n_valid = np.ones((k,), np.int32)
        for j, (_, _, eff, T, _, _) in enumerate(group):
            ids[j, :T] = eff
            n_valid[j] = T
        self.prefill_calls[(bucket, k)] = (
            self.prefill_calls.get((bucket, k), 0) + 1)
        if self._rtrace:
            # close the waiting span now, before the prefill, so the
            # compute lands in prefill_compute (charged at the end of
            # step() or at finish)
            for _, req, _, T, need, _ in group:
                tr = req.trace
                if tr is None:
                    continue
                wait = tr.pending_bucket
                tr.charge(wait)
                tr.event("resumed" if wait == "preempted" else "admitted",
                         tokens=T, pages=need)
                tr.event("prefill_chunk", tokens=T, pages=need)
                self._tick_roles[req.request_id] = (req, "prefill_compute")
        # the pages and offsets of ONE flat write for the whole group:
        # [L, k, T, kvh, d] -> [L, k*T, kvh, d]; padding rows and
        # beyond-prompt positions land on the scratch page
        pos = np.arange(bucket)
        page_ids = np.zeros((k, bucket), np.int32)
        offs = np.broadcast_to(pos % self.page, (k, bucket)).astype(np.int32)
        for j, (_, _, _, T, need, pages) in enumerate(group):
            page_ids[j] = np.where(
                pos < T,
                np.asarray(pages, np.int32)[
                    np.minimum(pos // self.page, need - 1)],
                0)
        cfg = self.cfg
        with _devev.execution("serving.prefill", self.device):
            ck = torch.zeros((cfg.num_hidden_layers, k, bucket, cfg.kv_heads,
                              cfg.head_dim), dtype=self.dtype,
                             device=self.device)
            cv = torch.zeros_like(ck)
            zeros = torch.zeros((k,), dtype=torch.int32, device=self.device)
            logits, k_new, v_new = L._forward_with_cache(
                self.state, cfg, self._dev(ids), ck, cv, zeros,
                wls=self._wls)
            last = logits[torch.arange(k, device=self.device),
                          self._dev(n_valid).long() - 1]
            L_ = k_new.shape[0]
            k_flat = k_new.reshape(L_, k * bucket, *k_new.shape[3:])
            v_flat = v_new.reshape(L_, k * bucket, *v_new.shape[3:])
            self._write_fn(k_flat, v_flat, self._dev(page_ids.reshape(-1)),
                           self._dev(offs.reshape(-1)))
            # a sampling engine SAMPLES the admission token too (the first
            # token of every request and of every preemption resume)
            toks = _next_tokens(last, self.greedy, self._gen)
        toks = toks.cpu().numpy()
        for j, (i, req, eff, T, need, pages) in enumerate(group):
            slot = self.slots[i]
            self.prefill_tokens_total += T
            self.slot_pages[i] = pages
            self.page_table[i, :] = 0
            self.page_table[i, :need] = pages
            slot.req = req
            req.status = "running"
            self._admitted_this_tick = True
            slot.length = T
            slot.produced = len(req.output) + 1
            slot.last_token = int(toks[j])
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            req.output.append(slot.last_token)
            self._note_first_token(req)
            self._maybe_finish(i)

    def _step_bucketed(self):
        """One bucketed tick: admission (batched prefills), decode page
        growth, then ONE decode step for every active slot."""
        self._admit()
        self._grow()
        active = np.array([not s.free for s in self.slots])
        if not active.any():
            return
        toks = self._dev(np.array([s.last_token for s in self.slots],
                                  np.int32))
        lens = np.array([s.length for s in self.slots], np.int32)
        active = self._dev(active)
        gen_before = None if self.greedy else self._gen.get_state()
        # one token for every active slot, straight over the page pool;
        # inactive slots keep their token
        with _devev.execution("serving.decode", self.device):
            lg, self.k_pool, self.v_pool = L._decode_step_paged(
                self.state, self.cfg, toks, self.k_pool, self.v_pool,
                self._dev(self.page_table), self._dev(lens), active,
                wls=self._wls)
            nxt = torch.where(active,
                              _next_tokens(lg, self.greedy, self._gen), toks)
            if self._slo:
                # a slot whose logits are not finite is quarantined
                # exactly (idle rows exempt)
                ok = torch.isfinite(lg).all(dim=-1) | ~active
        self.decode_steps += 1
        if self._slo:
            nxt, ok = self._read_back(nxt, ok)
            if self._discard_poisoned(ok, gen_before):
                return
        else:
            nxt = nxt.cpu().numpy()
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            slot.length += 1
            slot.produced += 1
            slot.last_token = int(nxt[i])
            slot.req.output.append(slot.last_token)
            if self._rtrace and slot.req.trace is not None:
                self._tick_roles.setdefault(
                    slot.req.request_id, (slot.req, "decode_compute"))
                slot.req.trace.event("decode_tick")
            self._maybe_finish(i)

    # -- chunked-prefill (ragged) scheduler ---------------------------------

    def _pick_waiter(self) -> int:
        """FIFO unless the prefix cache is warm: then the waiter with the
        most cached prefix pages (stable within equal heat), with a
        liveness cap of cache_jump_limit bypasses per waiter."""
        if (self._pcache is None or len(self.waiting) < 2
                or not self._pcache.entries):
            return 0
        if self.waiting[0].admit_bypassed >= self.cache_jump_limit:
            return 0
        epoch = self._pcache.epoch
        memo = self._probe_memo
        fresh: Dict[int, Tuple[int, int, int]] = {}
        best, best_key, best_hot = 0, None, 0
        for j, r in enumerate(self.waiting):
            ctx_len = len(r.prompt) + len(r.output)
            hit = memo.get(r.request_id)
            if hit is not None and hit[0] == epoch and hit[1] == ctx_len:
                hot = hit[2]
            else:
                hot = self._pcache.probe(list(r.prompt) + list(r.output))
            fresh[r.request_id] = (epoch, ctx_len, hot)
            if self._slo:
                # heat ranks below the SLO order (priority, then EDF)
                dl = r.deadline_at
                key = (-r.priority,
                       dl if dl is not None else float("inf"), -hot, j)
            else:
                key = (-hot, j)
            if best_key is None or key < best_key:
                best, best_key, best_hot = j, key, hot
        self._probe_memo = fresh
        if best != 0 and best_hot > 0:
            for r in self.waiting[:best]:
                r.admit_bypassed += 1
            self.cache_aware_admits += 1
            _CACHE_AWARE.inc()
        return best

    def _admit_ragged(self):
        """Token-granular admission: a waiter takes a free slot as soon
        as one exists and the pool has any free page; its prompt is
        funded page by page as chunks are scheduled."""
        free_slots = [i for i, s in enumerate(self.slots) if s.free]
        while self.waiting and free_slots and self.pool.n_free > 0:
            idx = self._pick_waiter()
            req = self.waiting[idx]
            eff = list(req.prompt) + list(req.output)
            if self._oversized(len(eff)):
                self.waiting.pop(idx)
                self._fail_request(req)
                continue
            self.waiting.pop(idx)
            i = free_slots.pop(0)
            slot = self.slots[i]
            cached: List[int] = []
            ckey = b""
            if self._pcache is not None:
                cached, ckey = self._pcache.lookup(eff)
            slot.req = req
            req.status = "running"
            self._admitted_this_tick = True
            slot.length = len(cached) * self.page
            slot.produced = len(req.output)
            slot.last_token = 0
            slot.pending = eff[slot.length:]
            slot.prefix_tokens = eff
            slot.cache_upto = len(cached)
            slot.cache_key = ckey
            slot.spec_k = self.max_draft_tokens
            slot.spec_calm = 0
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slot_pages[i] = list(cached)
            self.page_table[i, :] = 0
            if cached:
                self.page_table[i, :len(cached)] = cached
            if self._rtrace and req.trace is not None:
                tr = req.trace
                wait = tr.pending_bucket
                tr.charge(wait)
                tr.event("resumed" if wait == "preempted" else "admitted",
                         cached_pages=len(cached))
                if cached:
                    tr.event("prefix_reuse", pages=len(cached))

    def _schedule_chunks(self) -> List[Tuple[int, List[int], bool]]:
        """This tick's ragged batch: one decode row per decode-phase slot
        plus KV-budgeted prefill chunks in admission order. When every
        active slot is parked on a dry pool, preempt the latest
        admission so the head makes progress.
        Returns [(slot_idx, row_tokens, is_prefill)]."""
        while True:
            entries: List[Tuple[int, List[int], bool]] = []
            # adaptive degradation (SLO): the effective budget may sit
            # below max_chunk_tokens under pool pressure; _T_pack stays
            budget = self._eff_chunk if self._slo else self.max_chunk_tokens
            for i, slot in enumerate(self.slots):
                if not slot.free and not slot.pending:
                    entries.append((i, [slot.last_token], False))
            order = sorted((i for i, s in enumerate(self.slots)
                            if not s.free and s.pending),
                           key=lambda i: self.slots[i].admit_seq)
            for i in order:
                if budget <= 0:
                    break
                slot = self.slots[i]
                chunk = min(len(slot.pending), budget,
                            self.S - slot.length)
                have = len(self.slot_pages[i]) * self.page
                fundable = (have + self.pool.n_free * self.page
                            - slot.length)
                chunk = min(chunk, fundable)
                if chunk <= 0:
                    continue
                need = (-(-(slot.length + chunk) // self.page)
                        - len(self.slot_pages[i]))
                if need > 0:
                    pages = self.pool.alloc(need)
                    n0 = len(self.slot_pages[i])
                    self.slot_pages[i].extend(pages)
                    self.page_table[i, n0:n0 + need] = pages
                entries.append((i, list(slot.pending[:chunk]), True))
                self.prefill_tokens_total += chunk
                budget -= chunk
            if self._spec and budget > 0:
                # the leftover row budget funds draft tokens: prefill
                # always outranks speculation, and the packed total still
                # fits _T_pack
                self._fund_drafts(entries, budget)
            if entries:
                return entries
            active = [i for i, s in enumerate(self.slots) if not s.free]
            if not active:
                return entries
            victims = [i for i in active if self.slot_pages[i]] or active
            if self._slo:
                # the lowest priority yields first
                self._preempt(max(
                    victims, key=lambda j: (-self.slots[j].req.priority,
                                            self.slots[j].admit_seq)))
            else:
                self._preempt(max(victims,
                                  key=lambda j: self.slots[j].admit_seq))

    # -- self-speculative decoding -------------------------------------------

    def _draft_for_slot(self, i: int, budget: int) -> List[int]:
        """Up to slot.spec_k draft tokens for decode-phase slot i,
        clamped by the tick's spare row budget, the request's remaining
        token allowance (k + 1 tokens can land per verified entry), and
        the slot's KV capacity (rows write positions length..length+k)."""
        slot = self.slots[i]
        req = slot.req
        k = min(slot.spec_k, budget,
                req.max_new_tokens - slot.produced - 1,
                self.S - 1 - slot.length)
        if k <= 0:
            return []
        fault_point("serving.draft")
        return _ngram_propose(list(req.prompt) + list(req.output), k,
                              self.spec_max_ngram, self.spec_min_ngram)

    def _fund_drafts(self, entries, budget: int) -> None:
        """Extend decode rows with draft tokens, funding their KV pages
        at token granularity. Speculation is best-effort: it never takes
        the pool's LAST free page and never preempts, so decode growth,
        prefill chunks and admission are never starved by a bet."""
        page = self.page
        for idx, (i, rows, is_prefill) in enumerate(entries):
            if budget <= 0:
                break
            if is_prefill:
                continue
            drafts = self._draft_for_slot(i, budget)
            if not drafts:
                continue
            slot = self.slots[i]
            have = len(self.slot_pages[i]) * page
            spare = max(self.pool.n_free - 1, 0)
            # page funding, the per-slot KV ceiling and the verify window
            # (max_draft_tokens + 1 rows), enforced here even when an
            # overriding drafter ignores _draft_for_slot's clamps
            cap_tokens = min(have + spare * page - slot.length - 1,
                             self.S - 1 - slot.length,
                             self.max_draft_tokens, budget)
            drafts = drafts[:max(cap_tokens, 0)]
            if not drafts:
                continue
            need = (-(-(slot.length + 1 + len(drafts)) // page)
                    - len(self.slot_pages[i]))
            if need > 0:
                pages = self.pool.alloc(need)   # <= spare: succeeds
                if pages is None:
                    continue
                n0 = len(self.slot_pages[i])
                self.slot_pages[i].extend(pages)
                self.page_table[i, n0:n0 + need] = pages
            entries[idx] = (i, rows + drafts, False)
            budget -= len(drafts)

    def _verify_and_commit(self, i: int, rows: List[int], row_tok):
        """Greedy verification: row j's argmax is the true next token
        after row j's input, and draft d_j rode row j, so d_j is confirmed
        iff row j-1's argmax equals it. The longest agreeing prefix
        commits, plus the bonus token of the first disagreeing row;
        commits stop at max_new_tokens, at EOS and at the capacity cap.
        Rejected rows roll back exactly: the slot's length truncates, and
        pages wholly past it return to the pool through the refcounted
        free (draft rows only ever write past the prompt, so a
        prefix-shared page is never written; the refcount keeps it in any
        case). row_tok: [B, K] right-aligned verify-row argmax, this
        entry's n rows at K-n..K-1."""
        slot = self.slots[i]
        req = slot.req
        n = len(rows)
        drafted = n - 1
        K = row_tok.shape[1]
        cap = min(self.S, (self.pool.n_pages - 1) * self.page)
        appended = 0
        for j in range(n):
            t = int(row_tok[i, K - n + j])
            req.output.append(t)
            appended += 1
            slot.last_token = t
            slot.produced = len(req.output)
            if (slot.produced >= req.max_new_tokens
                    or (req.eos_token_id is not None
                        and t == req.eos_token_id)
                    or slot.length + j + 2 > cap - 1):
                break                    # the request finishes here
            if j + 1 < n and rows[j + 1] != t:
                break                    # draft j+1 refuted: t replaces it
        slot.length += appended
        accepted = min(appended - 1, drafted)
        keep = -(-slot.length // self.page)
        if len(self.slot_pages[i]) > keep:
            fault_point("serving.verify_rollback")
            extra = self.slot_pages[i][keep:]
            del self.slot_pages[i][keep:]
            self.page_table[i, keep:keep + len(extra)] = 0
            self.pool.free(extra)
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        req.spec_drafted += drafted
        req.spec_accepted += accepted
        if drafted:
            _SPEC_DRAFTED.inc(drafted)
        if accepted:
            _SPEC_ACCEPTED.inc(accepted)
        if self.spec_drafted:
            _SPEC_RATE.set(self.spec_accepted / self.spec_drafted)
        # adaptive draft length: back off fast, regrow slowly
        if accepted == drafted and drafted > 0:
            slot.spec_calm += 1
            if (slot.spec_calm >= self.spec_hysteresis
                    and slot.spec_k < self.max_draft_tokens):
                slot.spec_k = min(self.max_draft_tokens,
                                  max(slot.spec_k * 2, 1))
                slot.spec_calm = 0
        else:
            slot.spec_calm = 0
            if 2 * accepted < drafted:
                slot.spec_k = max(1, slot.spec_k // 2)
        if self._rtrace and req.trace is not None and drafted:
            tr = req.trace
            tr.event("draft_proposed", n=drafted)
            if accepted:
                tr.event("draft_accepted", n=accepted)
            if drafted - accepted:
                tr.event("draft_rejected", n=drafted - accepted)
            # a tick whose every draft was refuted bought nothing: its
            # wall is speculation overhead, not decode progress
            self._tick_roles[req.request_id] = (
                req, "draft_overhead" if accepted == 0 else "decode_compute")
        self._note_first_token(req)
        self._maybe_finish(i)

    def _offer_prefix(self, i: int):
        """Offer slot i's newly COMPLETED prompt pages to the index."""
        slot = self.slots[i]
        page = self.page
        limit = min(slot.length, len(slot.prefix_tokens)) // page
        while slot.cache_upto < limit:
            j = slot.cache_upto
            slot.cache_key = self._pcache.insert(
                slot.cache_key,
                slot.prefix_tokens[j * page:(j + 1) * page],
                self.slot_pages[i][j])
            slot.cache_upto += 1

    def _step_ragged(self):
        """One chunked-prefill tick: admission, decode page growth, chunk
        scheduling, then ONE ragged step covering every phase."""
        self._admit_ragged()
        self._grow()
        entries = self._schedule_chunks()
        if not entries:
            self.last_packed_tokens = 0
            return
        if self._rtrace:
            # what each request in flight does this tick; the span since
            # its last mark is charged to it at the end of step() or at
            # finish
            scheduled = set()
            for i, rows, is_prefill in entries:
                scheduled.add(i)
                r = self.slots[i].req
                if r is None or r.trace is None:
                    continue
                if is_prefill:
                    self._tick_roles[r.request_id] = (r, "prefill_compute")
                    r.trace.event("prefill_chunk", tokens=len(rows),
                                  pages=len(self.slot_pages[i]))
                else:
                    self._tick_roles.setdefault(
                        r.request_id, (r, "decode_compute"))
                    r.trace.event("decode_tick")
            for i, slot in enumerate(self.slots):
                if slot.free or i in scheduled:
                    continue
                r = slot.req
                if r is None or r.trace is None:
                    continue
                # active but unscheduled: parked on a dry pool or a spent
                # chunk budget
                self._tick_roles[r.request_id] = (r, "page_wait")
        B, page, T = self.B, self.page, self._T_pack
        toks = np.zeros((T,), np.int32)
        pos = np.zeros((T,), np.int32)
        page_ids = np.zeros((T,), np.int32)
        offs = np.zeros((T,), np.int32)
        q_start = np.zeros((B,), np.int32)
        q_len = np.zeros((B,), np.int32)
        kv_len = np.zeros((B,), np.int32)
        produce = np.zeros((B,), bool)
        prev = np.zeros((B,), np.int32)
        verify = np.zeros((B,), bool)    # decode entries (spec): every
        cur = 0                          # row's argmax may be consumed
        for i, rows, is_prefill in entries:
            slot = self.slots[i]
            n = len(rows)
            q_start[i] = cur
            q_len[i] = n
            kv_len[i] = slot.length + n
            prev[i] = slot.last_token
            verify[i] = not is_prefill
            # only a COMPLETED prompt (or a decode row) yields a token
            produce[i] = (not is_prefill) or n == len(slot.pending)
            for t, tok in enumerate(rows):
                p = slot.length + t
                toks[cur] = tok
                pos[cur] = p
                page_ids[cur] = self.page_table[i, p // page]
                offs[cur] = p % page
                cur += 1
        self.last_packed_tokens = cur
        _PACKED.observe(float(cur))
        dev = self._dev
        gen_before = None if self.greedy else self._gen.get_state()
        with _devev.execution("serving.ragged_step", self.device):
            out = self._ragged_fn()(
                self.state, dev(toks), self.k_pool, self.v_pool,
                dev(page_ids), dev(offs), dev(pos), dev(self.page_table),
                dev(q_start), dev(q_len), dev(kv_len), dev(produce),
                # the speculative step takes the verify mask where the
                # non-speculative one takes the previous tokens
                dev(verify if self._spec else prev), self._gen)
        self.model_steps += 1
        if self._slo:
            nxt, ok, self.k_pool, self.v_pool = out
            nxt, ok = self._read_back(nxt, ok)
            if self._discard_poisoned(ok, gen_before):
                return
        else:
            nxt, self.k_pool, self.v_pool = out
            nxt = nxt.cpu().numpy()
        for i, rows, is_prefill in entries:
            slot = self.slots[i]
            req = slot.req
            n = len(rows)
            if self._spec and not is_prefill and n > 1:
                # a decode row carrying drafts: commit the longest
                # agreeing prefix, roll the rest back
                self._verify_and_commit(i, rows, nxt)
                continue
            slot.length += n
            if is_prefill:
                del slot.pending[:n]
                if self._pcache is not None:
                    # this tick's step committed these rows' KV: fully
                    # written prompt pages join the index
                    self._offer_prefix(i)
                if slot.pending:
                    continue             # prompt still streaming in
            # speculation armed, a sequence's produced token is its last
            # row's, in the last slot of its right-aligned window
            tok = int(nxt[i, -1] if self._spec else nxt[i])
            slot.last_token = tok
            req.output.append(tok)
            slot.produced = len(req.output)
            self._note_first_token(req)
            self._maybe_finish(i)

    def cancel_request(self, req: GenerationRequest,
                       reason: str = "cancelled") -> bool:
        """Terminal 'cancelled' path for a client that went away: a
        waiting request leaves the queue, a running one releases its
        slot + pages. False if the request was not live."""
        if req in self.waiting:
            self.waiting.remove(req)
        else:
            for i, slot in enumerate(self.slots):
                if slot.req is req:
                    slot.req = None
                    slot.pending = []
                    self._free_slot_pages(i)
                    break
            else:
                return False
        req.status = "cancelled"
        req.error = reason
        req.finished_s = time.perf_counter()
        self._trace_settle(req, "cancelled")
        self.finished.append(req)
        return True

    # -- the SLO layer -----------------------------------------------------

    def _discard_poisoned(self, ok, gen_before) -> bool:
        """After a step, before any slot state advanced: when a consumed
        row's logits were not finite, quarantine exactly those requests
        and discard the tick (True). The other rows reschedule next tick
        and rewrite the same KV; a sampling engine's generator rewinds
        with the tick, so their draws repeat."""
        if ok.all():
            return False
        if gen_before is not None:
            self._gen.set_state(gen_before)
        for i in np.nonzero(~ok)[0]:
            self._quarantine_slot(int(i), "non-finite logits")
        return True

    def _pool_utilization(self) -> float:
        alloc = self.pool.n_pages - 1
        return (alloc - self.pool.n_free) / alloc if alloc else 0.0

    def _slo_pre_tick(self):
        """Deadline sweeps (waiting and in flight), the SLO queue order
        and the degradation controller: what must settle before this
        tick's admission and scheduling."""
        now = time.perf_counter()
        keep = []
        for r in self.waiting:
            dl = r.deadline_at
            if dl is not None and now >= dl:
                self._miss_deadline(r)
            else:
                keep.append(r)
        self.waiting[:] = keep
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            dl = slot.req.deadline_at
            if dl is not None and now >= dl:
                req = slot.req
                slot.req = None
                slot.pending = []
                self._free_slot_pages(i)
                self._miss_deadline(req)
        # (priority, earliest deadline) order; the sort is stable, so
        # equal keys keep FIFO / resume order
        if len(self.waiting) > 1:
            self.waiting.sort(key=lambda r: (
                -r.priority,
                r.deadline_at if r.deadline_at is not None
                else float("inf")))
        # degradation: halve the effective chunk budget under pool
        # pressure, double it back after a full hysteresis window of calm
        if self._ragged:
            util = self._pool_utilization()
            if util >= self.degrade_high_water:
                self._calm_ticks = 0
                if self._eff_chunk > self.min_chunk_tokens:
                    self._eff_chunk = max(self.min_chunk_tokens,
                                          self._eff_chunk // 2)
            elif util <= self.degrade_low_water:
                self._calm_ticks += 1
                if (self._calm_ticks >= self.degrade_hysteresis
                        and self._eff_chunk < self.max_chunk_tokens):
                    self._eff_chunk = min(self.max_chunk_tokens,
                                          self._eff_chunk * 2)
                    self._calm_ticks = 0
            else:
                self._calm_ticks = 0     # hysteresis band: hold
            _DEGRADED.set(
                1.0 if self._eff_chunk < self.max_chunk_tokens else 0.0)

    def _slo_post_tick(self):
        """Queue telemetry, the throughput EMA behind retry hints, and
        the shed controller (admission starvation)."""
        _QUEUE_DEPTH.set(float(len(self.waiting)))
        now = time.perf_counter()
        if self._last_tick_s is not None:
            dt = max(now - self._last_tick_s, 1e-6)
            tokens = (self.last_packed_tokens if self._ragged
                      else sum(not s.free for s in self.slots))
            rate = tokens / dt
            self._tokens_per_s = (rate if not self._tokens_per_s
                                  else 0.8 * self._tokens_per_s
                                  + 0.2 * rate)
        self._last_tick_s = now
        if self.max_queue_tokens is None:
            return                       # no admission control: no shed
        if self.waiting and not self._admitted_this_tick:
            self._pressure_ticks += 1
        else:
            self._pressure_ticks = 0
        if self._pressure_ticks >= self.shed_patience:
            self._shed_one()
            self._pressure_ticks = 0

    def _shed_one(self):
        """Shed the (lowest-priority, most-slack, latest-submitted)
        waiting request."""
        if not self.waiting:
            return

        def shed_key(r: GenerationRequest):
            slack = (r.deadline_at - time.perf_counter()
                     if r.deadline_at is not None else float("inf"))
            return (r.priority, -slack, -(r.request_id or 0))

        victim = min(self.waiting, key=shed_key)
        self.waiting.remove(victim)
        victim.status = "shed"
        victim.error = ("shed under sustained admission starvation "
                        f"({self.shed_patience} ticks)")
        victim.finished_s = time.perf_counter()
        self._trace_settle(victim, "shed")
        self.finished.append(victim)
        self.sheds += 1
        _SHEDS.inc()

    def _miss_deadline(self, req: GenerationRequest):
        req.status = "deadline_missed"
        req.error = (f"DeadlineExceeded: deadline_s={req.deadline_s} "
                     f"passed after {len(req.output)} token(s)")
        req.finished_s = time.perf_counter()
        self._trace_settle(req, "deadline_miss")
        self.finished.append(req)
        self.deadline_misses += 1
        _DEADLINE_MISSES.inc()

    def _fail_quarantined(self, req: GenerationRequest, reason: str):
        req.status = "failed"
        req.error = reason
        req.finished_s = time.perf_counter()
        self._trace_settle(req, "failed")
        self.finished.append(req)
        self.quarantines += 1
        _QUARANTINES.inc()

    def _quarantine_slot(self, i: int, reason: str):
        """Fail ONE in-flight request (slot and pages reclaimed) and keep
        serving everyone else."""
        slot = self.slots[i]
        req = slot.req
        slot.req = None
        slot.pending = []
        self._free_slot_pages(i)
        self._fail_quarantined(req, reason)

    def _on_tick_failure(self, exc: BaseException):
        """A tick raised a request-level fault. With no row to blame,
        suspicion falls on the latest admission (the data newest to the
        failing batch); with no active slot, on the queue head. More
        than B + 1 failures in a row re-raise: that is the engine's
        fault, not a request's. Called inside the except clause, so a
        bare raise re-raises `exc`."""
        self._tick_failures += 1
        if self._tick_failures > self.B + 1:
            raise
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if active:
            victim = max(active, key=lambda j: self.slots[j].admit_seq)
            self._quarantine_slot(victim, f"{type(exc).__name__}: {exc}")
        elif self.waiting:
            self._fail_quarantined(self.waiting.pop(0),
                                   f"{type(exc).__name__}: {exc}")
        else:
            raise                        # nothing to attribute it to

    def health_snapshot(self) -> dict:
        """Readiness view: pure host-side state, no device sync."""
        alloc = self.pool.n_pages - 1
        queued = self._queued_tokens()
        accepting = (self.max_queue_tokens is None
                     or queued < self.max_queue_tokens)
        snap = {
            "ready": True,
            "slo_armed": self._slo,
            "device": str(self.device),
            "ticks": self.ticks,
            "queue_depth": len(self.waiting),
            "queued_tokens": queued,
            "active_slots": sum(not s.free for s in self.slots),
            "max_batch": self.B,
            "kv_pages": {"total": alloc, "free": self.pool.n_free,
                         "utilization": round(self._pool_utilization(), 4)},
            "degraded": self._eff_chunk < self.max_chunk_tokens,
            "effective_chunk_tokens": self._eff_chunk,
            "max_chunk_tokens": self.max_chunk_tokens,
            "tokens_per_s_ema": round(self._tokens_per_s, 3),
            "accepting": accepting,
            "counters": {"deadline_misses": self.deadline_misses,
                         "sheds": self.sheds,
                         "quarantines": self.quarantines,
                         "preemptions": self.preemptions,
                         "cache_aware_admits": self.cache_aware_admits},
            "speculative": {
                "armed": self._spec,
                "max_draft_tokens": self.max_draft_tokens,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "acceptance_rate": (
                    round(self.spec_accepted / self.spec_drafted, 4)
                    if self.spec_drafted else 0.0),
            },
        }
        if self._pcache is not None:
            snap["prefix_cache"] = {**self._pcache.stats(),
                                    "page_size": self._pcache.page,
                                    "epoch": self._pcache.epoch,
                                    "heat": self._pcache.heat(),
                                    "heat_ts": time.time()}
        if not accepting:
            snap["retry_after_s"] = round(self._retry_after_hint(
                max(queued - self.max_queue_tokens, 1)), 3)
        return snap

    def _tick(self):
        if self._ragged:
            self._step_ragged()
        else:
            self._step_bucketed()

    def step(self) -> List[GenerationRequest]:
        """One scheduler tick. Ragged regime: admit, grow, then ONE mixed
        prefill-chunk + decode step. Bucketed regime: admit (batched
        prefills), grow, then one decode step for every active slot. SLO
        layer armed: deadline sweeps and the queue order before the
        tick, the isolation boundary (and the watchdog's section) around
        it, shedding and telemetry after it; a kernel's or the card's
        own error (`kernels._build.is_device_fault`) passes the boundary
        and raises here. Returns requests finished this tick."""
        n_done_before = len(self.finished)
        if not self._slo:
            self._tick()
        else:
            self._slo_pre_tick()
            self._admitted_this_tick = False
            try:
                if self._wd is not None:
                    with self._wd.section("serving.tick"):
                        fault_point("serving.tick")
                        self._tick()
                else:
                    fault_point("serving.tick")
                    self._tick()
                self._tick_failures = 0
            except Exception as exc:
                if _build.is_device_fault(exc):
                    raise
                self._on_tick_failure(exc)
            self._slo_post_tick()
        if self._rtrace:
            self._trace_charge_tick()
        if _metrics.enabled():
            _KV_PAGES.set(float(self.pool.n_pages - 1 - self.pool.n_free))
        self.ticks += 1
        return self.finished[n_done_before:]

    @property
    def has_work(self):
        return bool(self.waiting) or any(not s.free for s in self.slots)

    def run(self, requests: Optional[List[GenerationRequest]] = None,
            arrivals: Optional[List[float]] = None, max_ticks: int = 10000):
        """Drive until drained. `arrivals[i]` (seconds from start) delays
        request i's admission."""
        requests = requests or []
        order = sorted(range(len(requests)),
                       key=lambda i: (arrivals[i] if arrivals else 0.0))
        t0 = time.perf_counter()
        pending = [(arrivals[i] if arrivals else 0.0, requests[i])
                   for i in order]
        for _ in range(max_ticks):
            now = time.perf_counter() - t0
            while pending and pending[0][0] <= now:
                self.add_request(pending[0][1])
                pending.pop(0)
            if not self.has_work and not pending:
                break
            if not self.has_work and pending:
                time.sleep(max(0.0, pending[0][0] - now))
                continue
            self.step()
        return self.finished


# -- the /healthz provider ---------------------------------------------------

_health_engines = weakref.WeakSet()


def serving_health() -> dict:
    """Readiness view of every live SLO-armed engine (the "serving" part
    of `observability.export.health_payload()`)."""
    return {"engines": [e.health_snapshot() for e in list(_health_engines)]}


def _register_health_engine(engine) -> None:
    """SLO-armed engines publish health_snapshot() through the health
    registry. The registration is weak: an engine dies with its owner."""
    from ..observability import export as _oexp
    _health_engines.add(engine)
    _oexp.register_health_provider("serving", serving_health)
