"""Continuous-batching LLM serving over the paged KV cache, chunked-
prefill ("ragged") regime with the prefix cache (counterpart of
paddle_tpu/inference/serving.py).

A global KV PAGE POOL `[L, kvh, n_pages, page, d]` plus a host-side
free-list allocator and per-slot block tables: KV memory is
proportional to live tokens, not batch * max_seq. Admission splits
prompts into KV-budgeted prefill CHUNKS (`max_chunk_tokens` per tick)
packed into the SAME step as the active decode rows: one ragged
attention launch per layer per tick, rows padded to one fixed count
(`_T_pack`). Pool exhaustion preempts the latest-admitted sequence
(recompute-style resume). The prefix cache maps each fully-written
prompt PAGE (content-hash chain) to its physical page, so a later
prompt with the same leading pages attaches them (refcount++) and
prefills only the rest.

Differences from the reference, by design:
* the KV pools are torch tensors updated IN PLACE by index writes each
  tick (the reference donates its pools to the compiled step instead);
* the step runs eagerly on `device` (no jit); sampling draws from an
  explicit `torch.Generator` on the engine's device.

Not ported yet — asking for them raises NotImplementedError: the
bucketed regime (`ragged=False` / FLAGS_ragged_attention=0), the SLO
layer (`slo=True`: priorities, deadlines, queue bound, shedding,
degradation, fault isolation — `priority`/`deadline_s` on a request
are carried but not acted on), speculative decoding, request tracing,
int8 weights. The metrics/export/fault-injection hooks the reference
engine calls are absent.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework import core as _core
from ..framework.core import resolve_device
from ..kernels.ragged_paged_attention import _size_class
from ..models import llama as L
from .router import chain_key as _chain_key

__all__ = ["GenerationRequest", "ContinuousBatchingEngine", "PagePool"]


# ---------------- requests -------------------------------------------------

@dataclass
class GenerationRequest:
    """One decode job. `status` tracks the lifecycle: queued -> running
    -> served / failed / cancelled; `error` carries the terminal error
    text for the non-served outcomes. `priority` and `deadline_s` are
    the reference's SLO fields, carried for wire compatibility; no
    scheduling decision reads them until the SLO layer is ported."""
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
    # cache-aware admission: how many times a hotter-prefix waiter was
    # admitted ahead of this one (bounded by cache_jump_limit)
    admit_bypassed: int = 0

    @property
    def done(self) -> bool:
        return self.finished_s is not None


class _Slot:
    __slots__ = ("req", "length", "produced", "last_token", "admit_seq",
                 "pending", "prefix_tokens", "cache_upto", "cache_key")

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
        else:
            self.misses += 1
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


# ---------------- engine ---------------------------------------------------

class ContinuousBatchingEngine:
    """Slot-based continuous batching over the paged-KV ragged step.

    model: LlamaForCausalLM. max_batch = decode slots; max_seq = per-
    slot KV capacity (page-aligned); max_chunk_tokens bounds the prefill
    tokens packed into one tick; prefix_cache=None follows
    FLAGS_prefix_cache. device: where the step runs (default `cuda`;
    with no card this raises unless device='cpu' is passed). The
    reference's other knobs are accepted with their defaults; asking for
    an unported feature raises NotImplementedError (module docstring)."""

    def __init__(self, model, max_batch: int = 4, max_seq: int = 256,
                 prefill_buckets=(32, 64, 128, 256), quantize=None,
                 greedy: bool = True, seed: int = 0,
                 total_pages: Optional[int] = None, page_size: int = 16,
                 max_chunk_tokens: int = 64, ragged: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 speculative: Optional[bool] = None,
                 max_draft_tokens: Optional[int] = None,
                 cache_jump_limit: int = 8,
                 slo: Optional[bool] = None,
                 max_queue_tokens: Optional[int] = None,
                 request_trace: Optional[bool] = None,
                 device=None):
        self.device = resolve_device(device)
        self._ragged = (_core.get_bool_flag("FLAGS_ragged_attention", True)
                        if ragged is None else bool(ragged))
        unported = [(not self._ragged, "the bucketed regime (ragged=False)"),
                    (bool(speculative), "speculative decoding"),
                    (bool(slo), "the SLO layer (slo=True)"),
                    (max_queue_tokens is not None,
                     "admission control (max_queue_tokens, SLO layer)"),
                    (bool(request_trace), "request tracing"),
                    (quantize is not None, f"quantize={quantize!r}")]
        for asked, what in unported:
            if asked:
                raise NotImplementedError(f"{what} is not ported yet")
        if int(max_chunk_tokens) < 1:
            raise ValueError(
                f"max_chunk_tokens must be >= 1, got {max_chunk_tokens}")
        self.cfg = model.cfg
        self.B = int(max_batch)
        page = int(page_size)
        self.page = page
        self.S = int(-(-max_seq // page) * page)     # page-aligned
        self.ppmax = self.S // page
        self.greedy = greedy
        self.state = {k: v.detach().to(self.device)
                      for k, v in model.state_dict().items()}
        self.dtype = self.state["model.embed_tokens"].dtype
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
        pfx = (_core.get_bool_flag("FLAGS_prefix_cache", True)
               if prefix_cache is None else bool(prefix_cache))
        self._pcache = _PrefixCache(self.pool, page) if pfx else None
        self.cache_jump_limit = max(int(cache_jump_limit), 1)
        self.cache_aware_admits = 0
        self._probe_memo: Dict[int, Tuple[int, int, int]] = {}
        self.ticks = 0

    # -- memory accounting ---------------------------------------------------

    @property
    def kv_cache_bytes(self) -> int:
        return int(self.k_pool.nbytes + self.v_pool.nbytes)

    # -- the model step ------------------------------------------------------

    def _ragged_fn(self):
        """(state, toks[T], k_pool, v_pool, page_ids[T], offs[T], pos[T],
        page_table, q_start[B], q_len[B], kv_len[B], produce[B], prev[B],
        generator) -> (next[B], k_pool, v_pool) — ONE mixed prefill +
        decode step; next[b] comes from sequence b's last packed row and
        stays prev[b] where produce[b] is False."""
        cfg, greedy, wls = self.cfg, self.greedy, self._wls

        def rstep(state, toks, k_pool, v_pool, page_ids, offs, pos,
                  page_table, q_start, q_len, kv_len, produce, prev, gen):
            lg, k_pool, v_pool = L._ragged_step_paged(
                state, cfg, toks, pos, k_pool, v_pool, page_ids, offs,
                page_table, q_start, q_len, kv_len, wls=wls)
            if greedy:
                nxt = torch.argmax(lg, dim=-1).to(torch.int32)
            else:
                nxt = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                        generator=gen)[:, 0].to(torch.int32)
            nxt = torch.where(produce, nxt, prev)
            return nxt, k_pool, v_pool

        return rstep

    # -- scheduler ----------------------------------------------------------

    def check_request(self, req: GenerationRequest) -> None:
        """Reject a prompt that can never fit (ValueError). Reads only
        the engine's fixed sizes, so any thread may call it."""
        need = -(-len(req.prompt) // self.page)
        if need > self.pool.n_pages - 1:
            raise ValueError(
                f"prompt needs {need} pages but the pool only has "
                f"{self.pool.n_pages - 1} allocatable pages")
        if len(req.prompt) > self.S:
            raise ValueError(
                f"prompt length {len(req.prompt)} exceeds max_seq {self.S}")

    def add_request(self, req: GenerationRequest):
        self.check_request(req)
        if req.request_id is None:
            req.request_id = self._next_id
            self._next_id += 1
        req.arrived_s = time.perf_counter()
        req.status = "queued"
        self.waiting.append(req)
        return req.request_id

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
        self.waiting.insert(0, req)
        self.preemptions += 1

    def _oversized(self, eff_len: int) -> bool:
        return (-(-eff_len // self.page) > self.pool.n_pages - 1
                or eff_len > self.S)

    def _fail_request(self, req):
        req.status = "failed"
        req.error = "oversized resume stream"
        req.finished_s = time.perf_counter()
        self.finished.append(req)

    def _note_first_token(self, req):
        if len(req.output) == 1 and req.first_token_s is None:
            req.first_token_s = time.perf_counter()

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
                if victims:
                    self._preempt(max(
                        victims, key=lambda j: self.slots[j].admit_seq))
                else:
                    self._preempt(i)

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
            key = (-hot, j)
            if best_key is None or key < best_key:
                best, best_key, best_hot = j, key, hot
        self._probe_memo = fresh
        if best != 0 and best_hot > 0:
            for r in self.waiting[:best]:
                r.admit_bypassed += 1
            self.cache_aware_admits += 1
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
            slot.length = len(cached) * self.page
            slot.produced = len(req.output)
            slot.last_token = 0
            slot.pending = eff[slot.length:]
            slot.prefix_tokens = eff
            slot.cache_upto = len(cached)
            slot.cache_key = ckey
            slot.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slot_pages[i] = list(cached)
            self.page_table[i, :] = 0
            if cached:
                self.page_table[i, :len(cached)] = cached

    def _schedule_chunks(self) -> List[Tuple[int, List[int], bool]]:
        """This tick's ragged batch: one decode row per decode-phase slot
        plus KV-budgeted prefill chunks in admission order. When every
        active slot is parked on a dry pool, preempt the latest
        admission so the head makes progress.
        Returns [(slot_idx, row_tokens, is_prefill)]."""
        while True:
            entries: List[Tuple[int, List[int], bool]] = []
            budget = self.max_chunk_tokens
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
            if entries:
                return entries
            active = [i for i, s in enumerate(self.slots) if not s.free]
            if not active:
                return entries
            victims = [i for i in active if self.slot_pages[i]] or active
            self._preempt(max(victims,
                              key=lambda j: self.slots[j].admit_seq))

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
        cur = 0
        for i, rows, is_prefill in entries:
            slot = self.slots[i]
            n = len(rows)
            q_start[i] = cur
            q_len[i] = n
            kv_len[i] = slot.length + n
            prev[i] = slot.last_token
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

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        nxt, self.k_pool, self.v_pool = self._ragged_fn()(
            self.state, dev(toks), self.k_pool, self.v_pool, dev(page_ids),
            dev(offs), dev(pos), dev(self.page_table), dev(q_start),
            dev(q_len), dev(kv_len), dev(produce), dev(prev), self._gen)
        self.model_steps += 1
        nxt = nxt.cpu().numpy()
        for i, rows, is_prefill in entries:
            slot = self.slots[i]
            req = slot.req
            n = len(rows)
            slot.length += n
            if is_prefill:
                del slot.pending[:n]
                if self._pcache is not None:
                    # this tick's step committed these rows' KV: fully
                    # written prompt pages join the index
                    self._offer_prefix(i)
                if slot.pending:
                    continue             # prompt still streaming in
            tok = int(nxt[i])
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
        self.finished.append(req)
        return True

    def health_snapshot(self) -> dict:
        """Readiness view (the non-SLO part of the reference's): pure
        host-side state, no device sync."""
        alloc = self.pool.n_pages - 1
        snap = {
            "ready": True,
            "slo_armed": False,
            "device": str(self.device),
            "ticks": self.ticks,
            "queue_depth": len(self.waiting),
            "queued_tokens": sum(len(r.prompt) + len(r.output)
                                 for r in self.waiting),
            "active_slots": sum(not s.free for s in self.slots),
            "max_batch": self.B,
            "kv_pages": {"total": alloc, "free": self.pool.n_free,
                         "utilization": round(
                             (alloc - self.pool.n_free) / alloc
                             if alloc else 0.0, 4)},
            "max_chunk_tokens": self.max_chunk_tokens,
            "accepting": True,
            "counters": {"preemptions": self.preemptions,
                         "cache_aware_admits": self.cache_aware_admits},
        }
        if self._pcache is not None:
            snap["prefix_cache"] = {**self._pcache.stats(),
                                    "page_size": self._pcache.page,
                                    "epoch": self._pcache.epoch,
                                    "heat": self._pcache.heat(),
                                    "heat_ts": time.time()}
        return snap

    def step(self) -> List[GenerationRequest]:
        """One scheduler tick: admit, grow, then ONE mixed prefill-chunk
        + decode step. Returns requests finished this tick."""
        n_done_before = len(self.finished)
        self._step_ragged()
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
