// Flash attention on a TMA + mbarrier + wgmma core (sm_90a), BSHD in and
// out, causal or full, MHA and GQA (q head h reads kv head h / (Hq /
// Hk)), head dim 64 or 128, no bias; bf16 and f32, forward and backward.
// Two routes run here:
//   - the one-length route (q and kv of one length S, no segment ids):
//     `ptt_flash_attention_fwd_*` and `ptt_flash_attention_bwd_*` (LLaMA
//     training, ERNIE's encoder, sdpa without a mask);
//   - the segment route (`ptt_flash_attention_seg_fwd_*`, `_seg_dkv_*`,
//     `_seg_dq_*`: padding masks, packed documents, q and kv lengths Sq
//     and Sk of their own, with int32 segment ids [B, Sq] / [B, Sk] or
//     none).
// bf16 runs flash_fwd_wgmma_kernel<D, SEG>, flash_bwd_dkv_wgmma_kernel<D,
// SEG> and flash_bwd_dq_wgmma_kernel<D, SEG>; f32 their 3xTF32 forms
// flash_fwd_tf32_kernel<D, SEG>, flash_bwd_dkv_tf32_kernel<D, SEG> and
// flash_bwd_dq_tf32_kernel<D, SEG> (the one-length route is SEG = false).
// Only the bias route stays on flash_attention.cu. The bf16 forward's body
// also runs the block-stats kernel (`ptt_block_attention_fwd_bf16`,
// block_stats_wgmma_kernel<D>: its STATS mode, below).
//
// Replaces: paddle_tpu/kernels/flash_attention.py::flash_attention_bshd
//   -> upstream jax/experimental/pallas/ops/tpu/flash_attention.py (fwd
//   pallas_call l.758, bwd dkv l.1121, bwd dq l.1456) for MHA and the
//   splash MQA kernel (`_splash_gqa`) for GQA; the delta pre-pass is the
//   jnp rowsum(dO * O) of upstream's backward (l.1664). With `SegmentIds`,
//   the same forward behind `padding_mask=` (flash_attention.py:327-336,
//   GQA l.136-139) and `flash_attention_packed` (l.406). The STATS mode:
//   paddle_tpu/kernels/block_attention.py::block_attention_stats ->
//   _pallas_fwd (the pallas_call at l.138), bf16.
// Bound on the H100: operations. At llama_7b's training shape [4, 2048,
//   32, 128] causal the forward does 4 B H D S(S+1)/2 = 137.5 GFLOP
//   against 134 MB (0.139 ms at 989 TFLOP/s), the backward 2.5 times
//   that in the five products it needs (it runs seven: dkv and dq each
//   recompute S and dP). The delta pre-pass is bound by bytes (it reads
//   O and dO once: 134 MB, 0.04 ms). The segment forward at BERT's [16,
//   512, 12, 64] does 4 d per pair the segments leave (33.8 M pairs, 8.7
//   GFLOP) against 50 MB (bf16) or 101 MB (f32): bf16 is bound by bytes
//   (0.015 ms); f32 by operations, three tf32 products per product (26
//   GFLOP at 495 TFLOP/s: 0.052 ms). The f32 backward at ERNIE's [16,
//   512, 12, 64] full: 2.5 times the forward's 12.9 GFLOP, three tf32
//   products a product (97 GFLOP at 495 TFLOP/s: 0.195 ms).
// Design (FlashAttention-3's shape, without its ping-pong between
//   consumers): one block of three warpgroups owns one tile. Warpgroup 0
//   is the producer (registers cut by setmaxnreg): one thread issues
//   TMA loads of whole tiles of one head through a 4D tensor map over
//   BSHD (hopper.cuh, tma_map_bshd; a tile of D = 128 is two boxes of 64
//   bf16 columns, or four of 32 f32) into a ring whose stages carry full
//   and empty mbarriers.
//   Warpgroups 1 and 2 are consumers of 64 rows each. Every product is a
//   wgmma with f32 accumulators in registers: the score-like products (S
//   = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) read both operands
//   K-major from shared memory; the value-like products (O += P V, dV +=
//   P^T dO, dK += dS^T Q, dQ += dS K) take P or dS as the A operand from
//   registers, rounded to bf16 straight from the score accumulators'
//   layout (hopper.cuh, wgmma_rs), and the B operand MN-major from shared
//   memory, so no P or dS tile ever goes through shared memory. Each sum
//   starts with the product's scale-d = 0 and the accumulators are
//   fenced around every non-wgmma write (the online-softmax rescale of
//   O), which ptxas would otherwise serialise the products behind. The
//   forward and dq loops are software-pipelined (FA3's intra-warpgroup
//   overlap): tile j's score products are issued together with tile j -
//   1's value-like product, and the exponentials of tile j run on the
//   SFU (ex2.approx, in log2 units: 2^(s scale log2(e) - m)) while that
//   product is in flight. Their branches depend on the loop counter
//   alone: behind a branch on the warpgroup's own rows ptxas serialises
//   the products (C7520). dkv keeps the plain order: across the
//   overlap its 224 live registers spill and ptxas serialises the
//   products (C7514). Causal:
//   kv tiles past the diagonal are not loaded, the dkv consumer whose 64
//   kv rows follow every q row of a tile skips its products, and only
//   tiles that cross the diagonal or the ragged S edge (TMA zero-fills
//   rows past S within each batch) are masked; the heavy q tiles are
//   scheduled first.
//   Forward: a block owns 128 q rows of one head and walks the kv tiles
//     (128 rows a stage in bf16); it writes O and the f32 log-sum-exp
//     [B, Hq, Sq] (rows < Sq only).
//   Segment ids (SEG): a score counts where seg_q[b, i] == seg_kv[b, j];
//     a score whose segments differ takes upstream's finite mask value
//     kSegMask, placed in the log2 domain the exponent uses, so a row
//     with no key of its own segment averages V (P = 1) and writes lse =
//     kSegMask as flash_attention.cu's backward expects, and a key past
//     Sk or above the diagonal takes -inf. Before the roles split, the
//     whole block plans its walk (seg_plan): a kv tile is skipped when
//     its keys' [min, max] segment range misses the block's rows' range,
//     and only in a block each of whose rows holds its own segment at
//     its own position (i < Sk, seg_kv[i] == seg_q[i]); such a row has a
//     key of its own segment, so a skipped tile's P is exactly 0 for it.
//     Any other block may hold a row with none, which must average every
//     key: it walks every tile. The producer warp stages each visited
//     tile's ids (and a header: k0, and whether the tile and the block
//     are one segment, which spares the consumers the comparisons) in the
//     ring stage beside K and V.
//   f32 (flash_fwd_tf32_kernel): the tensor cores have no f32 product,
//     so each operand is split x = hi + lo in tf32 and each product is
//     hi hi + hi lo + lo hi: about 2^-21 of each term, against the f32
//     limit of 1e-4 of an element's sum of |terms| (testing.TERM_FRAC).
//     One tf32 product (2^-11) and a bf16 x3 split (about 3 * 2^-16 of
//     each term, times scale * sum |q k| of about 5 at BERT's inputs)
//     miss it. tf32 operands are read K-major only, so V is transposed
//     in shared memory (keys permuted within each group of 8 so that P
//     goes to its products from the score accumulators as they stand);
//     the consumers split and transpose each tile as it lands, and Q
//     once (its lo part stays in registers).
//   Backward, deterministic (no atomics: chip_smoke.py holds every remat
//     policy bitwise against no remat), P recomputed from the saved LSE:
//     delta: D = rowsum(dO * O) in f32, [B, H, S] (a vector pass);
//     dkv: a block owns 128 kv rows of one kv head and walks the q tiles
//       (64 rows a stage, with their LSE and D staged beside them by the
//       producer warp) of every q head of its group, so dk and dv sum
//       over the group in f32 registers; kv rows sit in the M position
//       of all four products;
//     dq: a block owns 128 q rows of one head and walks the kv tiles (64
//       rows a stage); q rows sit in the M position.
//     q, dO, LSE and D run over Sq, k and v over Sk (a tensor map per
//     length); rows past Sq stage LSE = +inf and D = 0 (P = 0), keys past
//     Sk take P = 0. With segment ids (SEG) the forward's rules carry
//     over: a producer warp stages each visited tile's ids and
//     one-segment header beside it, a pair whose segments differ takes
//     kSegMask in the log2 domain, and the LSE is read back into log2
//     units by lse_log2 (kSegMask stays kSegMask; times log2(e) it would
//     overflow to -inf and make P = 2^inf). dq walks the kv tiles of the
//     forward's plan at its own tiles (seg_plan<128, 64>); dkv walks the
//     q tiles of its own plan (seg_dkv_plan: the transposed rule, decided
//     once per kv block for every head of the group), its stages filled
//     by three producer warps (dkv_produce: TMA; LSE and D; ids), which
//     keeps each under setmaxnreg's 24 registers without a spill. The ids
//     are compared from shared memory, against the thread's two rows' ids
//     in registers, and only on mixed tiles (dkv_p_ds, dq_ds).
//   f32 backward (flash_bwd_dkv_tf32_kernel, flash_bwd_dq_tf32_kernel):
//     the bf16 walks, producers, plans and masks above, as the same code
//     (dkv_produce, seg_produce, the plans, dkv_p_ds, dq_ds), with every
//     product in 3xTF32 as the f32 forward forms it. tf32 is read K-major only,
//     and 3xTF32 keeps each operand twice, so everything sits in shared
//     memory as tf32 hi and lo parts: the block's resident tiles (dkv: K
//     and V; dq: Q and dO) split once, each streamed tile split by the
//     consumers as it lands, the value-like products' B operands
//     transposed there (dkv: Q^T and dO^T, q rows permuted within each
//     group of 8 as the forward's V^T keys are; dq: K^T), published by an
//     async-proxy fence and a barrier of the consumers. P^T, dS^T (dkv)
//     and dS (dq) are never rounded: they are split hi + lo in registers
//     straight from the score accumulators. The budget of 227 KB sets the
//     tiles (Tf32BwdGeo): at D = 64 two consumers of 64 rows against
//     32-row tiles (dkv one stage, dq two); at D = 128 one consumer of 64
//     rows against 16-row q tiles (dkv) or 32-key tiles (dq), one stage.
//     Neither runs the bf16 dq's software pipeline: their products wait
//     in order, which keeps each under 240 registers.
//   Block stats (STATS, bf16; the reference's semantics, block_attention.
//     py:89-126): the unnormalised (m, l, o) of q against one block of
//     keys, one head count, any Sq and Sk, an optional [Sq, Sk] boolean
//     mask and an optional f32 bias broadcastable to [B, H, Sq, Sk]. It is
//     bound by bytes where a full bias is read (the alibi chunk at
//     llama_7b width: the bias and the f32 o are 268 of its 371 MB), by
//     operations otherwise (the diagonal round of ring attention). The
//     forward's body with three changes: 64-key tiles whose ring stage
//     also holds the tile's bias and mask rows (a full bias tile by TMA
//     where its strides allow, else by one producer warp's 4-byte
//     cp.async, a dimension it is broadcast along staged once; the mask
//     rows by 16-byte cp.async), all completing on the stage's full
//     barrier beside K and V's TMA bytes; the scores assembled as (s scale
//     + bias) log2(e) where the entry is valid (key < Sk, the mask set,
//     the bias > -5e29) and -inf where not (p = 0 exactly, a fully masked
//     row keeps m = -inf: written as (-1e30, 0, 0)); and m, l [B, H, Sq]
//     and o [B, Sq, H, D] written in f32, unnormalised. Its grid runs the
//     batch fastest, so the blocks sharing a bias broadcast over batch
//     read it together from L2. P is rounded to bf16 for P V, as the
//     mma.sync kernel it replaces did (the SIMT f32 kernel stays in
//     block_attention.cu).
//   The bf16 kernels round P and dS to bf16 before their products, as the
//   mma.sync kernels and every flash kernel do; `scale` multiplies the
//   f32 scores (MHA); GQA callers pass q pre-scaled in q's dtype and
//   scale = 1.

#include <climits>
#include <type_traits>

#include "attention_tiles.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ptt::hopper;
using bf16 = __nv_bfloat16;
using ptt::attn::quad_max;
using ptt::attn::quad_sum;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU (ex2.approx, flush-to-zero: 2^-inf = 0); its relative
// error, about 2^-22, is far below the bf16 rounding of P
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kThreads = 384;        // producer + 2 consumer warpgroups

// the tile shapes: BM rows own the block's output (two consumers of 64),
// BN rows stream through the ring; NB 64-column boxes make a row of D
template <int D, int BM_, int BN_>
struct Geo {
  static constexpr int BM = BM_, BN = BN_, NB = D / 64, STAGES = 3;
  static constexpr int M_BYTES = BM * D * 2;   // one BM-row tile
  static constexpr int N_BYTES = BN * D * 2;   // one BN-row tile
};

// rows [r0, r0 + ROWS) of head h of batch b: NB boxes of [ROWS][128
// bytes] (64 bf16 or 32 f32 columns; the map's box is ROWS rows),
// completing on bar
template <int NB, int ROWS, typename T>
__device__ __forceinline__ void load_tile(T* dst, const CUtensorMap* map,
                                          uint64_t* bar, int b, int h,
                                          int r0) {
  constexpr int W = 128 / sizeof(T);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    hw::tma_load_4d(dst + nb * ROWS * W, map, bar, nb * W, h, r0, b);
}

// The producer's walk without segment ids: every kv tile in order, each
// into the next ring stage once the consumers have released it
template <int STAGES, class Load>
__device__ __forceinline__ void produce_all(int n_kv, uint64_t* full,
                                            uint64_t* empty,
                                            uint32_t tx_bytes, Load load) {
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    hw::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    hw::mbar_arrive_expect_tx(&full[s], tx_bytes);
    load(s, j);
  }
}

// K-major operand of 64 (A) or N (B) rows from row0 of a tile of R rows:
// k16 slice kk lies in box kk / 4, 32 bytes per slice into the row
template <int R>
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int row0,
                                           int kk) {
  return hw::desc_sw128(tile + (kk / 4) * R * 64 + row0 * 64 + (kk % 4) * 16,
                        16, 1024);
}

// MN-major B operand: the k dimension runs down the R rows of the tile
// (k16 slice kk = rows 16 kk..), N across its boxes (LBO = the box stride)
template <int R>
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int kk) {
  return hw::desc_sw128(tile + kk * 16 * 64, R * 64 * 2, 1024);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hw::smem_u32(p) & 1023)) & 1023);
}

// ------------------------------- forward ----------------------------------

// upstream's DEFAULT_MASK_VALUE (-0.7 * float32 max): the score of a key
// in another segment. It is placed after the scaling, as the log2-domain
// score itself (kSegMask * log2(e) would overflow to -inf): a row that
// meets it as its maximum gets P = 2^0 = 1 for every such key, a row with
// a real maximum gets 2^(kSegMask - m) = 0, and the epilogue writes such
// a row's natural-log lse as kSegMask + log(l), which rounds to kSegMask
// as flash_attention.cu's kernels and upstream write it.
constexpr float kSegMask = -2.3819763e38f;
// the kv tiles whose visit the prologue decides, one bit each (the
// tiles past them are always visited)
constexpr int kVisitWords = 64;
constexpr int kVisitTiles = kVisitWords * 32;
// a stage's segment slice: {k0, mixed, -, -} then the tile's BN ids
constexpr int kSegHdr = 4;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The segment forwards' visit plan, run by all kThreads threads of the
// block before the roles split: which of the first n_kv kv tiles (BN keys
// each) the block's q rows [q0, q0 + BM) visit. A tile is skipped when
// the [min, max] segment range of its keys (< Sk) and that of the block's
// rows (< Sq) are disjoint: then no (row, key) pair of the two shares a
// segment. Skipping is exact only for a row that has a key of its own
// segment somewhere (its masked entries then take P = 2^(kSegMask - m) =
// 0); a row with none averages V over every key, skipped tiles included.
// So a block skips only when every row i of it has its own segment at its
// own position (i < Sk and seg_kv[i] == seg_q[i], as padding masks with
// Sq == Sk and packed self-attention give), which proves that no row of
// it lacks one; any other block visits every tile. Returns the number of
// visited tiles; qmm = the block's rows' {min, max} segment. NT: the
// block's threads.
template <int BM, int BN, int NT = kThreads>
__device__ __forceinline__ int seg_plan(const int* __restrict__ seg_q,
                                        const int* __restrict__ seg_kv,
                                        int b, int q0, int Sq, int Sk,
                                        int n_kv, int* part,
                                        uint32_t* visit, int (&qmm)[2]) {
  static_assert(BM <= NT, "one thread a q row");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kVisitWords; i += NT) visit[i] = 0u;
  if (warp < BM / 32) {
    const int row = q0 + tid;
    int mn = INT_MAX, mx = INT_MIN, bad = 0;
    if (row < Sq) {
      mn = mx = seg_q[static_cast<size_t>(b) * Sq + row];
      bad = !(row < Sk && seg_kv[static_cast<size_t>(b) * Sk + row] == mn);
    }
    mn = warp_min(mn);
    mx = warp_max_i(mx);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      part[4 * warp] = mn;
      part[4 * warp + 1] = mx;
      part[4 * warp + 2] = bad;
    }
  }
  __syncthreads();
  int bad = 0;
  qmm[0] = INT_MAX;
  qmm[1] = INT_MIN;
#pragma unroll
  for (int w = 0; w < BM / 32; ++w) {
    qmm[0] = min(qmm[0], part[4 * w]);
    qmm[1] = max(qmm[1], part[4 * w + 1]);
    bad |= part[4 * w + 2];
  }
  const int n_scan = min(n_kv, kVisitTiles);
  for (int j = warp; j < n_scan; j += NT / 32) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = lane; r < BN; r += 32) {
      const int key = j * BN + r;
      if (key < Sk) {
        const int v = seg_kv[static_cast<size_t>(b) * Sk + key];
        mn = min(mn, v);
        mx = max(mx, v);
      }
    }
    mn = warp_min(mn);
    mx = warp_max_i(mx);
    if (lane == 0 && (bad || !(mx < qmm[0] || mn > qmm[1])))
      atomicOr(&visit[j >> 5], 1u << (j & 31));
  }
  __syncthreads();
  int n = n_kv - n_scan;
  for (int w = 0; w < (n_scan + 31) / 32; ++w) n += __popc(visit[w]);
  return n;
}

__device__ __forceinline__ bool visited(const uint32_t* visit, int j) {
  return j >= kVisitTiles || ((visit[j >> 5] >> (j & 31)) & 1u);
}

// The segment forwards' producer warp: walks the visited tiles, and for
// each waits for its ring stage, stages the tile's segment ids (and a
// header: k0, and whether any pair of it may differ in segment) beside
// the tile, then lane 0 starts the tile's TMA loads (`load(stage, j)`)
// against full[stage], which counts the 32 lanes' arrivals.
template <int BN, int STAGES, class Load>
__device__ __forceinline__ void seg_produce(const int* __restrict__ seg_kv,
                                           int b, int Sk, int n_kv,
                                           const uint32_t* visit,
                                           const int (&qmm)[2], int* segs,
                                           uint64_t* full, uint64_t* empty,
                                           uint32_t tx_bytes, Load load) {
  const int lane = threadIdx.x & 31;
  for (int j = 0, it = 0; j < n_kv; ++j) {
    if (!visited(visit, j)) continue;
    const int s = it % STAGES;
    hw::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    int* st = segs + s * (kSegHdr + BN);
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = lane; r < BN; r += 32) {
      const int key = j * BN + r;
      int v = 0;
      if (key < Sk) {
        v = seg_kv[static_cast<size_t>(b) * Sk + key];
        mn = min(mn, v);
        mx = max(mx, v);
      }
      st[kSegHdr + r] = v;
    }
    mn = warp_min(mn);
    mx = warp_max_i(mx);
    if (lane == 0) {
      st[0] = j * BN;
      st[1] = !(mn == mx && qmm[0] == qmm[1] && mn == qmm[0]);
      hw::mbar_arrive_expect_tx(&full[s], tx_bytes);
      load(s, j);
    } else {
      hw::mbar_arrive(&full[s]);
    }
    ++it;
  }
}

template <int N>
__device__ __forceinline__ void softmax_update(float (&sc)[N],
                                              float (&m2)[2], float (&l)[2],
                                              float (&alpha)[2]);

// The online-softmax step shared by the forwards: sc (this thread's
// elements of S [64 x BN]) into P in log2 units, against the row state
// m2 / l; alpha the rescale of the previous tiles. Entries whose segments
// differ (a `mixed` tile; ids: the stage's BN ids, sq this thread's two
// rows' segments) take kSegMask; a key past Sk or above the causal
// diagonal -inf (`edge` tiles only). Branches here are on data, never
// around a product.
template <int BN>
__device__ __forceinline__ void softmax_step(float (&sc)[BN / 2],
                                            float (&m2)[2], float (&l)[2],
                                            float (&alpha)[2], float sl2,
                                            bool mixed, const int* ids,
                                            const int (&sq)[2], bool edge,
                                            int k0, int c_off, int r0,
                                            int Sk, int causal) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int hh = (i >> 1) & 1;
    const int cl = 8 * (i >> 2) + c_off;         // the pair's first key
    float x0 = sc[i] * sl2, x1 = sc[i + 1] * sl2;
    if (mixed) {
      const int2 kv = *reinterpret_cast<const int2*>(ids + cl);
      if (kv.x != sq[hh]) x0 = kSegMask;
      if (kv.y != sq[hh]) x1 = kSegMask;
    }
    if (edge) {
      const int col = k0 + cl, row = r0 + 8 * hh;
      if (col >= Sk || (causal && col > row)) x0 = -INFINITY;
      if (col + 1 >= Sk || (causal && col + 1 > row)) x1 = -INFINITY;
    }
    sc[i] = x0;
    sc[i + 1] = x1;
  }
  softmax_update(sc, m2, l, alpha);
}

// The online-softmax update shared by the forwards and the block-stats
// mode: against the row state m2 / l, the log2-unit scores sc (this
// thread's elements of S [64 x 2N]; -inf where masked) become P, alpha
// the rescale of the previous tiles. A row whose every score so far is
// -inf keeps m2 = -inf and takes P = 0 and alpha = 0.
template <int N>
__device__ __forceinline__ void softmax_update(float (&sc)[N],
                                              float (&m2)[2], float (&l)[2],
                                              float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m2[r], quad_max(mx[r]));
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(m2[r] - m_use[r]);
    m2[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    sc[i] = ex2(sc[i] - m_use[(i >> 1) & 1]);
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// the natural-log lse of a row from its log2-unit maximum and its sum
// (kSegMask stays as it is: see kSegMask)
__device__ __forceinline__ float row_lse(float m2, float lsum) {
  return (m2 == kSegMask ? kSegMask : m2 * kLn2) + logf(lsum);
}

template <int D>
using FwdGeo = Geo<D, 128, 128>;

// the barriers after a ring: the resident tile's, then full and empty
// per stage, 8 bytes each, in 64 bytes or, past three stages, the next
// 16-byte multiple; the stages' segment slices start after them
__host__ __device__ constexpr int mbar_area(int stages) {
  return 8 * (1 + 2 * stages) <= 64 ? 64 : (8 * (1 + 2 * stages) + 15) / 16 * 16;
}

// Q, the ring (K then V per stage), the barriers, the stages' segment
// slices, the plan's partials and visit bits, and the alignment slack
template <int BM, int STAGES, int BN>
constexpr int seg_extra() {
  return mbar_area(STAGES) + STAGES * (kSegHdr + BN) * 4 + 4 * (BM / 32) * 4 +
         kVisitWords * 4 + 1024;
}

template <int D>
constexpr int fwd_smem() {
  using G = FwdGeo<D>;
  return G::M_BYTES + G::STAGES * 2 * G::N_BYTES +
         seg_extra<G::BM, G::STAGES, G::BN>();
}

// ------------------------- forward: block-stats mode ------------------------

constexpr float kStatsNeg = -1e30f;          // block_attention.py's _NEG
constexpr float kMaskedBias = -5e29f;        // a bias at or below: masked
// the stats tiles: 128 q rows (a band) against 64 keys
constexpr int kStatsBM = 128, kStatsBN = 64;
// the tile classes of a mask (stats_mask_bits_kernel)
constexpr unsigned char kTileNone = 0, kTileAll = 1, kTileMixed = 2;

// The block-stats mode's operands: the mask as bits, one 64-bit word per
// row per 64-key tile, tile-major ([n_tiles][bits_ld] words: bit c of word
// (j, i) is entry (i, 64 j + c)), and each tile's class per 128-row band
// ([bands][n_tiles]), both from stats_mask_bits_kernel, or null; the f32
// bias read at bias[b sb + h sh + i sq + j sk] or null (bias_tma where a
// full bias tile comes by TMA, `map_bias`); the
// unnormalised m, l [B, H, Sq] and o [B, Sq, H, D], f32, out.
struct StatsArgs {
  const uint64_t* bits;
  const unsigned char* tiles;
  const float* bias;
  long long sb, sh, sq, sk;
  float *m, *l, *o;
  int n_tiles, bits_ld, bias_tma;
};

// The block-stats mode's tiles: 128 q rows against 64-key tiles. A ring
// stage holds K, V, the tile's bias and the mask bits of its 128 rows
// (1 KB). FULL (a bias that varies along queries and keys, as a
// materialised alibi chunk): the bias tile [128][64] f32 as two 128-byte
// swizzled boxes of 32 keys (the TMA's layout, which keeps the score
// assembly's float2 reads at two ways a bank), 64 KB a stage at D = 128:
// two stages there, three at D = 64. Otherwise the bias is at most a row
// of 64 or a column of 128 floats, and four stages fit.
template <int D, bool FULL>
struct StatsGeo {
  static constexpr int BM = kStatsBM, BN = kStatsBN, NB = D / 64;
  static constexpr int STAGES = FULL ? (D == 64 ? 3 : 2) : 4;
  static constexpr int M_BYTES = BM * D * 2, N_BYTES = BN * D * 2;
  static constexpr int BIAS_BYTES = FULL ? BM * BN * 4 : 1024;
  static constexpr int BITS_BYTES = BM * 8;
  static constexpr int STAGE_BYTES =
      (2 * N_BYTES + BIAS_BYTES + BITS_BYTES + 1023) / 1024 * 1024;
};

// a forward ring stage: K, then V (STATS: then the bias and the mask bits)
template <int D, int STATS>
__host__ __device__ constexpr int fwd_stage_bytes() {
  if constexpr (STATS != 0) return StatsGeo<D, STATS == 2>::STAGE_BYTES;
  else return 2 * FwdGeo<D>::N_BYTES;
}

template <int D, bool FULL>
constexpr int stats_smem() {
  using G = StatsGeo<D, FULL>;
  return G::M_BYTES + G::STAGES * G::STAGE_BYTES +
         seg_extra<G::BM, G::STAGES, G::BN>() + kVisitWords * 4;
}

// the byte offset of bias entry (r, c) in a FULL stage's bias tile: box c
// / 32 of [128 rows][128 bytes], 16-byte chunk (c % 32) / 4 of row r at
// chunk ((c % 32) / 4) ^ (r % 8) (CU_TENSOR_MAP_SWIZZLE_128B)
__host__ __device__ __forceinline__ int bias_at(int r, int c) {
  return (c >> 5) * (kStatsBM * 128) + r * 128 +
         ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// The tile classes and bits of a block-stats mask [Sq, mask_ld] uint8
// (nonzero: set): one block of 128 threads a (band, key tile), a thread a
// row. Writes the row's 64-bit word (keys past Sk and rows past Sq clear)
// and the tile's class: kTileNone where no entry of it is set, kTileAll
// where every entry (row < Sq, key < Sk) is, kTileMixed otherwise.
__global__ void __launch_bounds__(kStatsBM)
stats_mask_bits_kernel(const unsigned char* __restrict__ mask, int mask_ld,
                       int Sq, int Sk, uint64_t* __restrict__ bits,
                       int bits_ld, unsigned char* __restrict__ tiles) {
  const int j = blockIdx.x, band = blockIdx.y;
  const int row = band * kStatsBM + threadIdx.x;
  const int k0 = j * kStatsBN;
  uint64_t w = 0;
  if (row < Sq) {
    const unsigned char* src = mask + static_cast<size_t>(row) * mask_ld + k0;
#pragma unroll
    for (int c = 0; c < kStatsBN; c += 16) {
      if (k0 + c >= Sk) break;                 // Sk <= mask_ld, both % 16
      const uint4 v = *reinterpret_cast<const uint4*>(src + c);
      const unsigned char* e = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
      for (int x = 0; x < 16; ++x)
        if (e[x] != 0 && k0 + c + x < Sk) w |= 1ull << (c + x);
    }
  }
  bits[static_cast<size_t>(j) * bits_ld + row] = w;
  const int n = min(kStatsBN, Sk - k0);
  const uint64_t full = n >= 64 ? ~0ull : (1ull << n) - 1ull;
  const int any = __syncthreads_or(w != 0);
  const int all = __syncthreads_and(row >= Sq || w == full);
  if (threadIdx.x == 0)
    tiles[static_cast<size_t>(band) * gridDim.x + j] =
        any ? (all ? kTileAll : kTileMixed) : kTileNone;
}

// The block-stats mode's visit plan, run by all the block's threads
// before the roles split: with a mask, the classes of the block's band
// mark the kv tiles to visit (any class but kTileNone) in visit[] and
// those whose mask bits must be read (kTileMixed) in visit[kVisitWords +
// ...]; a tile past kVisitTiles is visited and mixed. Skipping a
// kTileNone tile is exact: its entries take p = 0 and no part in the row
// max. A band with no tile to visit visits tile 0, mixed (every entry
// invalid: (-1e30, 0, 0)). Without a mask every tile is visited, none
// mixed. Returns the number of visited tiles.
__device__ __forceinline__ int stats_plan(const StatsArgs& sa, int band,
                                          int n_kv, uint32_t* visit) {
  const int tid = threadIdx.x;
  uint32_t* mixed = visit + kVisitWords;
  for (int i = tid; i < 2 * kVisitWords; i += kThreads) visit[i] = 0u;
  __syncthreads();
  const int n_scan = min(n_kv, kVisitTiles);
  for (int j = tid; j < n_scan; j += kThreads) {
    const int c = sa.tiles == nullptr
                      ? kTileAll
                      : sa.tiles[static_cast<size_t>(band) * sa.n_tiles + j];
    if (c != kTileNone) atomicOr(&visit[j >> 5], 1u << (j & 31));
    if (c == kTileMixed) atomicOr(&mixed[j >> 5], 1u << (j & 31));
  }
  __syncthreads();
  int n = n_kv - n_scan;
  for (int w = 0; w < (n_scan + 31) / 32; ++w) n += __popc(visit[w]);
  if (n == 0) {
    if (tid == 0) {
      visit[0] = 1u;
      mixed[0] = 1u;
    }
    __syncthreads();
    n = 1;
  }
  return n;
}

// The block-stats producer, one warp (the producer warpgroup's other
// three exit: a warp spinning on a barrier takes issue slots from the
// consumer warps of its SM sub-partition): for each visited kv tile j, in
// stage s, lane 0 writes the stage's header (k0, whether the tile is
// mixed) and starts K and V, and a FULL bias tile where it comes by TMA
// (`map_bias`: dims {Sk, Sq, H or 1, B or 1}, a dimension the bias is
// broadcast along kept at size 1), all on full[s]'s transaction count;
// the lanes copy the rest by cp.async, each lane's completion arriving
// on full[s] (1 + 32 arrivals a phase): a FULL bias that TMA cannot read
// (4-byte copies into the same swizzled layout), a narrower bias (a row of
// 64 or a column of 128 floats, or one value), and a mixed tile's mask
// bits (1 KB). Copies are zero-filled past Sq and Sk. Before it exits,
// the warp waits for the last tile's copies.
template <class G, bool FULL, class Load>
__device__ __forceinline__ void stats_produce(
    const StatsArgs& sa, const CUtensorMap* map_bias, int b, int h, int q0,
    int Sq, int Sk, int n_kv, int n_vis, const uint32_t* visit,
    unsigned char* ring, int* segs, uint64_t* full, uint64_t* empty,
    Load load) {
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  constexpr int SB = G::STAGE_BYTES;
  const int lane = threadIdx.x;
  const bool tma = FULL && sa.bias_tma;
  const float* bias =
      sa.bias == nullptr ? nullptr : sa.bias + b * sa.sb + h * sa.sh;
  for (int j = 0, it = 0; j < n_kv; ++j) {
    if (!visited(visit, j)) continue;
    const int s = it % STAGES;
    hw::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    unsigned char* st = ring + s * SB + 2 * G::N_BYTES;
    const int k0 = j * BN;
    const bool mixed = sa.bits != nullptr && visited(visit + kVisitWords, j);
    if (lane == 0) {
      int* hdr = segs + s * (kSegHdr + BN);
      hdr[0] = k0;
      hdr[1] = mixed;
      hw::mbar_arrive_expect_tx(&full[s],
                                2 * G::N_BYTES + (tma ? BM * BN * 4 : 0));
      load(s, j);
      if (tma) {
        hw::tma_load_4d(st, map_bias, &full[s], k0, q0, sa.sh ? h : 0,
                        sa.sb ? b : 0);
        hw::tma_load_4d(st + BM * 128, map_bias, &full[s], k0 + 32, q0,
                        sa.sh ? h : 0, sa.sb ? b : 0);
      }
    }
    if (bias != nullptr && !tma) {
      // FULL: every (r, c) at its swizzled place; otherwise the row (sq
      // == 0: c), the column (sk == 0: r) or the one value
      const int rows = sa.sq != 0 ? BM : 1, cols = sa.sk != 0 ? BN : 1;
      for (int e = lane; e < rows * cols; e += 32) {
        const int r = e / cols, c = e % cols;
        const bool in = q0 + r < Sq && k0 + c < Sk;
        hw::cp_async4(st + (FULL ? bias_at(r, c) : 4 * (r + c)),
                      in ? bias + (q0 + r) * sa.sq + (k0 + c) * sa.sk
                         : sa.bias,
                      in ? 4 : 0);
      }
    }
    if (mixed) {
      const uint64_t* src = sa.bits + static_cast<size_t>(j) * sa.bits_ld + q0;
      for (int e = lane; e < BM / 2; e += 32)
        ptt::cp_async16(st + G::BIAS_BYTES + 16 * e, src + 2 * e, 16);
    }
    hw::cp_async_arrive_noinc(&full[s]);
    ++it;
  }
  // a lane must not exit with its copies' arrivals pending
  hw::mbar_wait(&full[(n_vis - 1) % STAGES], ((n_vis - 1) / STAGES) & 1);
}

// The block-stats mode's score assembly: this thread's elements of S [64
// x 64] into log2-unit scores (s scale + bias) log2(e) where the entry is
// valid (its key < Sk, its mask bit set, its bias > -5e29) and -inf where
// it is not, so that it takes p = 0 exactly and no part in the row max (a
// -inf bias is one more invalid entry, never subtracted). stg: the stage's
// bias (FULL: the swizzled tile; else a row (brow false), a column (bcol
// false) or one value); bits: the stage's mask bits or null (a tile every
// entry of which is set); row: this thread's first row in the block's
// band (its second is row + 8).
template <class G, bool FULL>
__device__ __forceinline__ void stats_scores(
    float (&sc)[G::BN / 2], float scale, const unsigned char* stg,
    bool bias, bool brow, bool bcol, const uint64_t* bits, int row, int k0,
    int c_off, int Sk) {
  uint64_t mw[2] = {~0ull, ~0ull};
  if (bits != nullptr) {
    mw[0] = bits[row];
    mw[1] = bits[row + 8];
  }
  const float* bs = reinterpret_cast<const float*>(stg);
#pragma unroll
  for (int i = 0; i < G::BN / 2; i += 2) {
    const int hh = (i >> 1) & 1;
    const int cl = 8 * (i >> 2) + c_off;         // the pair's first key
    const int r = row + 8 * hh;
    float x0 = sc[i] * scale, x1 = sc[i + 1] * scale;
    bool v0 = k0 + cl < Sk && ((mw[hh] >> cl) & 1u);
    bool v1 = k0 + cl + 1 < Sk && ((mw[hh] >> (cl + 1)) & 1u);
    if (bias) {
      float b0, b1;
      if (FULL) {
        const float2 bb = *reinterpret_cast<const float2*>(stg + bias_at(r, cl));
        b0 = bb.x;
        b1 = bb.y;
      } else if (bcol) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + cl);
        b0 = bb.x;
        b1 = bb.y;
      } else {
        b0 = b1 = bs[brow ? r : 0];
      }
      v0 = v0 && b0 > kMaskedBias;
      v1 = v1 && b1 > kMaskedBias;
      x0 += b0;
      x1 += b1;
    }
    sc[i] = v0 ? x0 * kLog2e : -INFINITY;
    sc[i + 1] = v1 ? x1 * kLog2e : -INFINITY;
  }
}

// The bf16 forward's body, for q [B, Sq, Hq, D] against k/v [B, Sk, Hk,
// D]; SEG: segment ids seg_q [B, Sq], seg_kv [B, Sk] (the visit plan, the
// staged slices, kSegMask). Causal needs Sq == Sk. Without ids every tile
// is visited and the producer is one thread. STATS (block_stats_wgmma_
// kernel; Hq == Hk, not causal, no ids; 2: a FULL bias tile, 1: a narrower
// bias or none): the StatsGeo tiles, the visit plan of the mask's tile
// classes (stats_plan), the bias and mask bits staged beside K and V by
// one producer warp (stats_produce), the scores assembled by
// stats_scores, and the unnormalised (m, l, o) written in f32 instead of
// o and the lse.
template <int D, bool SEG, int STATS>
__device__ __forceinline__ void fwd_wgmma_body(
    const CUtensorMap& map_q, const CUtensorMap& map_k,
    const CUtensorMap& map_v, const CUtensorMap* map_bias,
    const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
    bf16* __restrict__ o, float* __restrict__ lse, const StatsArgs& sa,
    int Sq, int Sk, int Hq, int Hk, int causal, float scale) {
  using G = std::conditional_t<STATS != 0, StatsGeo<D, STATS == 2>,
                               FwdGeo<D>>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  constexpr int SB = fwd_stage_bytes<D, STATS>();
  static_assert(8 * (1 + 2 * STAGES) <= mbar_area(STAGES),
                "the barriers overlap the stages' headers");
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + G::M_BYTES;     // stage s: K, then V
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * SB);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(q_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));

  // heavy tiles first (causal; the stats grid's last bands visit the most
  // tiles under a causal mask); the stats grid runs the batch fastest: the
  // blocks that share a bias broadcast over batch run together and read it
  // once from L2
  const int qt = STATS ? gridDim.y - 1 - blockIdx.y
                       : gridDim.x - 1 - blockIdx.x;
  const int h = STATS ? blockIdx.z : blockIdx.y;
  const int b = STATS ? blockIdx.x : blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], SEG ? 32 : (STATS ? 33 : 1));
      hw::mbar_init(&empty[s], 8);           // one arrival per consumer warp
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(q_full, G::M_BYTES);
    load_tile<G::NB, BM>(Qs, &map_q, q_full, b, h, q0);
  }
  __syncthreads();
  int qmm[2] = {0, 0};
  int n_vis = n_kv;
  if constexpr (SEG)
    n_vis = seg_plan<BM, BN>(seg_q, seg_kv, b, q0, Sq, Sk, n_kv, part, visit,
                             qmm);
  if constexpr (STATS != 0) n_vis = stats_plan(sa, qt, n_kv, visit);

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    // the stats producer's copy loops take 32 registers; the consumers
    // then keep 232 (384 x 168 in all)
    if constexpr (STATS) hw::setmaxnreg_dec<32>();
    else hw::setmaxnreg_dec<24>();
    auto load = [&](int s, int j) {
      bf16* Ks = reinterpret_cast<bf16*>(ring + s * SB);
      load_tile<G::NB, BN>(Ks, &map_k, &full[s], b, hk, j * BN);
      load_tile<G::NB, BN>(Ks + BN * D, &map_v, &full[s], b, hk, j * BN);
    };
    if constexpr (STATS != 0) {
      if (threadIdx.x < 32)
        stats_produce<G, STATS == 2>(sa, map_bias, b, h, q0, Sq, Sk, n_kv,
                                     n_vis, visit, ring, segs, full, empty,
                                     load);
    } else if (SEG) {
      if (threadIdx.x < 32)
        seg_produce<BN, STAGES>(seg_kv, b, Sk, n_kv, visit, qmm, segs, full,
                                empty, 2 * G::N_BYTES, load);
    } else if (threadIdx.x == 0) {
      produce_all<STAGES>(n_kv, full, empty, 2 * G::N_BYTES, load);
    }
  } else {
    if constexpr (STATS) hw::setmaxnreg_inc<232>();
    else hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int row_lo = q0 + cw * 64;           // this consumer's 64 rows
    const int r0 = row_lo + (t >> 5) * 16 + (lane >> 2);  // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    int sq[2] = {0, 0};                        // this thread's rows' segments
    if (SEG) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        sq[hh] = row < Sq ? seg_q[static_cast<size_t>(b) * Sq + row] : 0;
      }
    }

    // software-pipelined: tile j's S = Q K^T is issued together with
    // tile j - 1's O += P V, and its softmax runs while the latter is in
    // flight; O is rescaled once that product has retired
    float acc[D / 2];                          // O [64 x D]
    float sc[BN / 2];                          // S [64 x BN], then P
    uint32_t pf[BN / 16][4];                   // P of the previous tile
    float m2[2] = {-INFINITY, -INFINITY};      // row max, log2 units
    float l[2] = {0.f, 0.f};                   // this thread's row sums
    hw::mbar_wait(q_full, 0);
    for (int j = 0; j < n_vis; ++j) {
      const int s = j % STAGES;
      const int sp = (j + STAGES - 1) % STAGES;  // the previous tile's
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
      const bf16* Ks = reinterpret_cast<const bf16*>(ring + s * SB);
      const int* st = segs + s * (kSegHdr + BN);
      const int k0 = (SEG || STATS) ? st[0] : j * BN;

      hw::fence_regs(sc);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hw::wgmma_ss<0, 0>(sc, kmajor<BM>(Qs, cw * 64, kk),
                           kmajor<BN>(Ks, 0, kk), kk > 0);
      hw::wgmma_commit();
      if (j > 0) {
        const bf16* Vp = reinterpret_cast<const bf16*>(
                             ring + sp * SB) + BN * D;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hw::wgmma_rs<1>(acc, pf[kk], mnmajor<BN>(Vp, kk), j > 1 || kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<1>();
      } else {
        hw::wgmma_wait<0>();
      }
      hw::fence_regs(sc);

      float alpha[2];
      if constexpr (STATS != 0) {
        const unsigned char* stg = ring + s * SB + 2 * G::N_BYTES;
        stats_scores<G, STATS == 2>(
            sc, scale, stg, sa.bias != nullptr, sa.sq != 0, sa.sk != 0,
            st[1] ? reinterpret_cast<const uint64_t*>(stg + G::BIAS_BYTES)
                  : nullptr,
            r0 - q0, k0, c_off, Sk);
        softmax_update(sc, m2, l, alpha);
      } else {
        softmax_step<BN>(sc, m2, l, alpha, sl2, SEG && st[1], st + kSegHdr,
                         sq, (causal && k0 + BN > row_lo) || k0 + BN > Sk, k0,
                         c_off, r0, Sk, causal);
      }
      if (j > 0) {
        // the previous tile's P V has retired: its V is read, O is whole
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        if (lane == 0) hw::mbar_arrive(&empty[sp]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      // P as bf16 pairs: the A fragments of this tile's P V
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          pf[kk][x] = ptt::pack_bf16(sc[8 * kk + 2 * x],
                                     sc[8 * kk + 2 * x + 1]);
    }
    {
      // the last tile's P V (n_vis >= 1: q0 < Sq, and the plan visits
      // the tile of some row's own key)
      const int sl = (n_vis + STAGES - 1) % STAGES;
      const bf16* Vl =
          reinterpret_cast<const bf16*>(ring + sl * SB) + BN * D;
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hw::wgmma_rs<1>(acc, pf[kk], mnmajor<BN>(Vl, kk), n_vis > 1 || kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]);
      const int row = r0 + 8 * hh;
      if (row >= Sq) continue;
      if constexpr (STATS != 0) {
        // unnormalised, f32; a row with no valid entry: (-1e30, 0, 0)
        float* dst = sa.o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + c_off;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<float2*>(dst + 8 * jj) =
              make_float2(acc[4 * jj + 2 * hh], acc[4 * jj + 2 * hh + 1]);
        if ((lane & 3) == 0) {
          const size_t at = (static_cast<size_t>(b) * Hq + h) * Sq + row;
          sa.m[at] = m2[hh] == -INFINITY ? kStatsNeg : m2[hh] * kLn2;
          sa.l[at] = lsum;
        }
      } else {
        const float inv = 1.f / lsum;
        bf16* dst = o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + c_off;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(dst + 8 * jj) = ptt::pack_bf16(
              acc[4 * jj + 2 * hh] * inv, acc[4 * jj + 2 * hh + 1] * inv);
        if ((lane & 3) == 0)
          lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
              row_lse(m2[hh], lsum);
      }
    }
  }
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const int* __restrict__ seg_q,
                       const int* __restrict__ seg_kv,
                       bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                       int Sk, int Hq, int Hk, int causal, float scale) {
  const StatsArgs none{};
  fwd_wgmma_body<D, SEG, 0>(map_q, map_k, map_v, nullptr, seg_q, seg_kv, o,
                            lse, none, Sq, Sk, Hq, Hk, causal, scale);
}

// The block-stats kernel (row 8's bf16 route): the forward core's body in
// its STATS mode, q [B, Sq, H, D] against k/v [B, Sk, H, D]; FULL: a bias
// tile that varies along queries and keys (map_bias where sa.bias_tma).
template <int D, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
block_stats_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_bias,
                         const __grid_constant__ StatsArgs sa, int Sq,
                         int Sk, int H, float scale) {
  fwd_wgmma_body<D, false, FULL ? 2 : 1>(map_q, map_k, map_v, &map_bias,
                                         nullptr, nullptr, nullptr, nullptr,
                                         sa, Sq, Sk, H, H, 0, scale);
}

// -------------------------- forward, f32 (3xTF32) --------------------------

// The f32 forward's tiles: 128 q rows (two consumers of 64) against kv
// tiles of BN keys in a two-stage ring; D = 128 takes 32-key tiles so
// that Q and two stages fit in 227 KB.
template <int D>
struct F32Geo {
  static constexpr int BM = 128, BN = D == 64 ? 64 : 32, STAGES = 2;
  static constexpr int NB = D / 32;                // 32-float boxes a row
  static constexpr int Q_BYTES = BM * D * 4;
  static constexpr int T_BYTES = BN * D * 4;       // one kv tile
  // a stage: K (split in place to its hi part), K's lo part, V as loaded,
  // V^T's hi and lo parts
  static constexpr int STAGE_BYTES = 5 * T_BYTES;
};

template <int D>
constexpr int fwd_f32_smem() {
  using G = F32Geo<D>;
  return G::Q_BYTES + G::STAGES * G::STAGE_BYTES +
         seg_extra<G::BM, G::STAGES, G::BN>();
}

// element (row, col) of an f32 tile of R rows stored as 128-byte-swizzled
// boxes of [R][32 columns]
template <int R>
__device__ __forceinline__ int f32_at(int row, int col) {
  return (col >> 5) * R * 32 + row * 32 +
         ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

// K-major tf32 operand of 64 (A) or N (B) rows from row0 of an f32 tile
// of R rows: the k8 slice kk lies in box kk / 4, 32 bytes per slice
template <int R>
__device__ __forceinline__ uint64_t kmajor_f32(const float* tile, int row0,
                                               int kk) {
  return hw::desc_sw128(tile + (kk / 4) * R * 32 + row0 * 32 + (kk % 4) * 8,
                        16, 1024);
}

// x = hi + lo, both tf32 (lo the rounded remainder): |x - hi - lo| <=
// 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = hw::tf32_round(x);
  lo = hw::tf32_round(x - hi);
}

// The key whose V row stands at position kap of V^T's k order: within
// each group of 8 the keys run [0, 2, 4, 6, 1, 3, 5, 7], so that a k8
// slice of P's tf32 A fragment (columns c and c + 4 of each quad) is the
// score accumulators' pair (2c, 2c + 1) of the same group as it stands;
// this is the inverse, the position of key r.
__device__ __forceinline__ int vt_pos(int r) {
  const int w = r & 7;
  return (r & ~7) | ((w & 1) ? 4 + (w >> 1) : (w >> 1));
}

// The f32 forward on the tensor cores (3xTF32): every f32 operand x is
// split x = hi + lo in tf32, and each product is hi hi + hi lo + lo hi
// (the lo lo term, <= 2^-22 of the product, dropped), so a term carries
// about 2^-21 of its magnitude. Q is split once: hi in place in shared
// memory, lo in registers as A fragments. Each kv tile is converted by
// the two consumers, half each, once it lands: K split in place plus a lo
// copy, V transposed (tf32 reads both operands K-major, and P V's k is
// the key) with the key order of vt_pos into hi and lo tiles, all
// published to the tensor cores by an async-proxy fence and a barrier of
// the two consumers. S = Qhi Klo + Qlo Khi + Qhi Khi (the small terms
// first), O += Phi Vlo + Plo Vhi + Phi Vhi with P split in registers
// straight from the score accumulators. The softmax, the segment rules
// and the pipeline are the bf16 forward's.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_kv, float* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Sk, int Hq, int Hk,
                      int causal, float scale) {
  using G = F32Geo<D>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  constexpr int TF = G::T_BYTES / 4;           // floats in a kv tile
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + G::Q_BYTES;
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(q_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));
  // stage s: K (hi after the split), K lo, V, V^T hi, V^T lo
  auto tile = [&](int s, int which) {
    return reinterpret_cast<float*>(ring + s * G::STAGE_BYTES) + which * TF;
  };

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], SEG ? 32 : 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(q_full, G::Q_BYTES);
    load_tile<G::NB, BM>(Qs, &map_q, q_full, b, h, q0);
  }
  __syncthreads();
  int qmm[2] = {0, 0};
  const int n_vis =
      SEG ? seg_plan<BM, BN>(seg_q, seg_kv, b, q0, Sq, Sk, n_kv, part, visit,
                             qmm)
          : n_kv;

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    auto load = [&](int s, int j) {
      load_tile<G::NB, BN>(tile(s, 0), &map_k, &full[s], b, hk, j * BN);
      load_tile<G::NB, BN>(tile(s, 2), &map_v, &full[s], b, hk, j * BN);
    };
    if (SEG) {
      if (threadIdx.x < 32)
        seg_produce<BN, STAGES>(seg_kv, b, Sk, n_kv, visit, qmm, segs, full,
                                empty, 2 * G::T_BYTES, load);
    } else if (threadIdx.x == 0) {
      produce_all<STAGES>(n_kv, full, empty, 2 * G::T_BYTES, load);
    }
  } else {
    hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int g = lane >> 2, c = lane & 3;
    const int row_lo = q0 + cw * 64;
    const int r0 = row_lo + (t >> 5) * 16 + g;   // + 8 hh
    const int c_off = 2 * c;
    const float sl2 = scale * kLog2e;
    int sq[2] = {0, 0};
    if (SEG) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        sq[hh] = row < Sq ? seg_q[static_cast<size_t>(b) * Sq + row] : 0;
      }
    }

    // Q: this consumer's 64 rows split, hi in place, lo kept as the A
    // fragments of the Qlo Khi product
    uint32_t qlo[D / 8][4];
    hw::mbar_wait(q_full, 0);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float* p = Qs + f32_at<BM>(cw * 64 + (t >> 5) * 16 + g + 8 * (x & 1),
                                   8 * kk + c + 4 * (x >> 1));
        float hi, lo;
        split_tf32(*p, hi, lo);
        *p = hi;
        qlo[kk][x] = __float_as_uint(lo);
      }
    hw::fence_proxy_async();
    hw::named_sync(2 + cw, 128);

    float acc[D / 2];                          // O [64 x D]
    float sc[BN / 2];                          // S [64 x BN], then P
    uint32_t ph[BN / 8][4], pl[BN / 8][4];     // P of the previous tile
    float m2[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};
    for (int j = 0; j < n_vis; ++j) {
      const int s = j % STAGES;
      const int sp = (j + STAGES - 1) % STAGES;
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
      const int* st = segs + s * (kSegHdr + BN);
      const int k0 = SEG ? st[0] : j * BN;
      float* Kh = tile(s, 0);
      float* Kl = tile(s, 1);
      {
        // this consumer's half of the tile: K split in place, V
        // transposed into V^T's hi and lo (row d, position vt_pos(key))
        float4* k4 = reinterpret_cast<float4*>(Kh);
        float4* l4 = reinterpret_cast<float4*>(Kl);
        for (int i = cw * TF / 8 + t; i < (cw + 1) * TF / 8; i += 128) {
          const float4 x = k4[i];
          float4 hi, lo;
          split_tf32(x.x, hi.x, lo.x);
          split_tf32(x.y, hi.y, lo.y);
          split_tf32(x.z, hi.z, lo.z);
          split_tf32(x.w, hi.w, lo.w);
          k4[i] = hi;
          l4[i] = lo;
        }
        const float* Vs = tile(s, 2);
        float* Vh = tile(s, 3);
        float* Vl = tile(s, 4);
        for (int i = cw * TF / 8 + t; i < (cw + 1) * TF / 8; i += 128) {
          const int r = i % BN, d0 = 4 * (i / BN);
          const float4 x =
              *reinterpret_cast<const float4*>(Vs + f32_at<BN>(r, d0));
          const float xs[4] = {x.x, x.y, x.z, x.w};
          const int kap = vt_pos(r);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float hi, lo;
            split_tf32(xs[e], hi, lo);
            Vh[f32_at<D>(d0 + e, kap)] = hi;
            Vl[f32_at<D>(d0 + e, kap)] = lo;
          }
        }
        hw::fence_proxy_async();
        hw::named_sync(1, 256);
      }

      hw::fence_regs(sc);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        hw::wgmma_tf32_ss(sc, kmajor_f32<BM>(Qs, cw * 64, kk),
                          kmajor_f32<BN>(Kl, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        hw::wgmma_tf32_rs(sc, qlo[kk], kmajor_f32<BN>(Kh, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        hw::wgmma_tf32_ss(sc, kmajor_f32<BM>(Qs, cw * 64, kk),
                          kmajor_f32<BN>(Kh, 0, kk), 1);
      hw::wgmma_commit();
      if (j > 0) {
        const float* Vh = tile(sp, 3);
        const float* Vl = tile(sp, 4);
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          hw::wgmma_tf32_rs(acc, ph[kk], kmajor_f32<D>(Vl, 0, kk),
                            j > 1 || kk > 0);
          hw::wgmma_tf32_rs(acc, pl[kk], kmajor_f32<D>(Vh, 0, kk), 1);
          hw::wgmma_tf32_rs(acc, ph[kk], kmajor_f32<D>(Vh, 0, kk), 1);
        }
        hw::wgmma_commit();
        hw::wgmma_wait<1>();
      } else {
        hw::wgmma_wait<0>();
      }
      hw::fence_regs(sc);

      float alpha[2];
      softmax_step<BN>(sc, m2, l, alpha, sl2, SEG && st[1], st + kSegHdr,
                       sq, (causal && k0 + BN > row_lo) || k0 + BN > Sk, k0,
                       c_off, r0, Sk, causal);
      if (j > 0) {
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        if (lane == 0) hw::mbar_arrive(&empty[sp]);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
      // P split: the k8 slice kk of P V holds keys 8kk + {2c, 2c + 1} at
      // its columns {c, c + 4} (vt_pos), the accumulators' own pair
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        const float p[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                            sc[4 * kk + 3]};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float hi, lo;
          split_tf32(p[x], hi, lo);
          ph[kk][x] = __float_as_uint(hi);
          pl[kk][x] = __float_as_uint(lo);
        }
      }
    }
    {
      const int sl = (n_vis + STAGES - 1) % STAGES;
      const float* Vh = tile(sl, 3);
      const float* Vl = tile(sl, 4);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) {
        hw::wgmma_tf32_rs(acc, ph[kk], kmajor_f32<D>(Vl, 0, kk),
                          n_vis > 1 || kk > 0);
        hw::wgmma_tf32_rs(acc, pl[kk], kmajor_f32<D>(Vh, 0, kk), 1);
        hw::wgmma_tf32_rs(acc, ph[kk], kmajor_f32<D>(Vh, 0, kk), 1);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]);
      const int row = r0 + 8 * hh;
      if (row >= Sq) continue;
      const float inv = 1.f / lsum;
      float* dst = o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(
            acc[4 * jj + 2 * hh] * inv, acc[4 * jj + 2 * hh + 1] * inv);
      if ((lane & 3) == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] =
            row_lse(m2[hh], lsum);
    }
  }
}

// --------------------------- backward: delta ------------------------------

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d] in f32: D / V
// threads a BSHD row, one 16-byte vector each (V elements of T)
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, int rows, int S, int H) {
  constexpr int V = ptt::Vec<T>::N;
  constexpr int TPR = D / V;                 // threads a row: 8, 16 or 32
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long row = tid / TPR;
  const int c = static_cast<int>(tid % TPR) * V;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + c);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < V; ++e) acc += ptt::to_f(gv[e]) * ptt::to_f(av[e]);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const long long bs = row / H;            // b * S + s
    const int hh = static_cast<int>(row % H);
    const long long bb = bs / S;
    const int ss = static_cast<int>(bs % S);
    delta[(bb * H + hh) * S + ss] = acc;
  }
}

// ------------------------------- backward ----------------------------------

// A row's natural-log lse in the log2 units of P = 2^(s scale log2(e) -
// lse2). The exact inverse of row_lse: a row with no key of its own
// segment has lse == kSegMask, and kSegMask * log2(e) overflows to -inf,
// which would give it P = 2^+inf and NaN gradients; its lse stays
// kSegMask, so that its masked keys take P = 2^(kSegMask - kSegMask) = 1,
// as the forward averaged them, and a real row's take 2^(kSegMask - lse2)
// = 0.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == kSegMask ? kSegMask : lse * kLog2e;
}

// The dkv visit plan, run by all kThreads threads of the block before the
// roles split: which of the n_q q tiles (BN rows each, the first at row
// q_begin) the block's kv rows [k0, k0 + BM) visit. seg_plan's rule
// transposed, decided per q tile: a tile is skipped when the [min, max]
// segment range of its rows (< Sq) misses that of the block's keys (<
// Sk), and only when each of its rows i holds its own segment at its own
// position (i < Sk and seg_kv[i] == seg_q[i]). Such a row has a key of
// its own segment (visible under causal: j = i), so its lse is a real one
// and its P on keys of other segments is exactly 0. A row without one has
// lse == kSegMask and P = 1 on every key it sees, so it adds to every dk
// and dv: its tile is visited. One pass of int32 loads over the q rows
// (seg_q[i], and seg_kv[i] for the own-position test); the ids do not
// depend on the head, so the plan serves every q head of the GQA group.
// Beside the visit bits it sets the mixed bits: a tile whose rows and
// the block's keys are not all of one segment, whose pairs the consumers
// must compare (tiles past kVisitTiles count as mixed). Returns the
// number of visited tiles. NT: the block's threads.
template <int BM, int BN, int NT = kThreads>
__device__ __forceinline__ int seg_dkv_plan(const int* __restrict__ seg_q,
                                            const int* __restrict__ seg_kv,
                                            int b, int k0, int q_begin,
                                            int Sq, int Sk, int n_q,
                                            int* part, uint32_t* visit,
                                            uint32_t* mixed) {
  static_assert(BM <= NT, "one thread a kv row");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kVisitWords; i += NT) {
    visit[i] = 0u;
    mixed[i] = 0u;
  }
  if (warp < BM / 32) {
    const int key = k0 + tid;
    int mn = INT_MAX, mx = INT_MIN;
    if (key < Sk) mn = mx = seg_kv[static_cast<size_t>(b) * Sk + key];
    mn = warp_min(mn);
    mx = warp_max_i(mx);
    if (lane == 0) {
      part[4 * warp] = mn;
      part[4 * warp + 1] = mx;
    }
  }
  __syncthreads();
  int kmm[2] = {INT_MAX, INT_MIN};            // the block's keys' range
#pragma unroll
  for (int w = 0; w < BM / 32; ++w) {
    kmm[0] = min(kmm[0], part[4 * w]);
    kmm[1] = max(kmm[1], part[4 * w + 1]);
  }
  const int n_scan = min(n_q, kVisitTiles);
  for (int j = warp; j < n_scan; j += NT / 32) {
    int mn = INT_MAX, mx = INT_MIN, bad = 0;
    for (int r = lane; r < BN; r += 32) {
      const int row = q_begin + j * BN + r;
      if (row < Sq) {
        const int v = seg_q[static_cast<size_t>(b) * Sq + row];
        mn = min(mn, v);
        mx = max(mx, v);
        bad |= !(row < Sk && seg_kv[static_cast<size_t>(b) * Sk + row] == v);
      }
    }
    mn = warp_min(mn);
    mx = warp_max_i(mx);
    bad = __any_sync(0xffffffffu, bad);
    if (lane == 0) {
      if (bad || !(mx < kmm[0] || mn > kmm[1]))
        atomicOr(&visit[j >> 5], 1u << (j & 31));
      if (!(mn == mx && kmm[0] == kmm[1] && mn == kmm[0]))
        atomicOr(&mixed[j >> 5], 1u << (j & 31));
    }
  }
  __syncthreads();
  int n = n_q - n_scan;
  for (int w = 0; w < (n_scan + 31) / 32; ++w) n += __popc(visit[w]);
  return n;
}

// ------------------------------ backward: dkv ------------------------------

// full[s]'s arrivals in a dkv stage: the TMA thread, the LSE / D warp and,
// with ids, the ids warp (dkv_produce)
__host__ __device__ constexpr int dkv_full_arrivals(bool seg) {
  return seg ? 65 : 33;
}

// The dkv producer warpgroup, shared by the bf16 and 3xTF32 kernels: the
// `total` stages are every q head of the group in turn over the visited
// q tiles (BN rows each, the first at row q_begin). Three warps fill each
// stage, so that none holds more than setmaxnreg's 24 registers: warp 0's
// first thread starts the q tile's TMA loads (`tma(stage, head, q0)`:
// its arrive-expect-tx and loads against full[stage]), warp 1 stages the
// tile's LSE (log2 units; +inf past Sq: P = 0) and D into lsd, and with
// ids warp 2 stages the tile's segments and the header {q0, mixed} (the
// plan's mixed bit) into segs.
template <int BN, int STAGES, bool SEG, class Tma>
__device__ __forceinline__ void dkv_produce(
    Tma&& tma, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, float* lsd, int* segs,
    const uint32_t* visit, const uint32_t* mixed, uint64_t* full,
    uint64_t* empty, int b, int hk, int group, int Hq, int Sq, int q_begin,
    int n_q, int total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto walk = [&](auto&& fill) {
    for (int it = 0, g = 0, j = -1; it < total; ++it) {
      do {                                     // the next visited tile
        if (++j == n_q) {
          j = 0;
          ++g;
        }
      } while (SEG && !visited(visit, j));
      const int s = it % STAGES;
      hw::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      fill(s, hk * group + g, j, q_begin + j * BN);
    }
  };
  if (warp == 0 && lane == 0) {
    walk([&](int s, int h, int, int q0) { tma(s, h, q0); });
  } else if (warp == 1) {
    walk([&](int s, int h, int, int q0) {
      float* ls = lsd + s * 2 * BN;
#pragma unroll
      for (int r = lane; r < BN; r += 32) {
        const int row = q0 + r;
        const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + row;
        ls[r] = row < Sq ? lse_log2(lse[i]) : INFINITY;
        ls[BN + r] = row < Sq ? delta[i] : 0.f;
      }
      hw::mbar_arrive(&full[s]);
    });
  } else if (SEG && warp == 2) {
    walk([&](int s, int, int j, int q0) {
      int* hdr = segs + s * (kSegHdr + BN);
#pragma unroll
      for (int r = lane; r < BN; r += 32) {
        const int row = q0 + r;
        hdr[kSegHdr + r] =
            row < Sq ? seg_q[static_cast<size_t>(b) * Sq + row] : 0;
      }
      if (lane == 0) {
        hdr[0] = q0;
        hdr[1] = j >= kVisitTiles || ((mixed[j >> 5] >> (j & 31)) & 1u);
      }
      hw::mbar_arrive(&full[s]);
    });
  }
}

// P^T and dS^T in place of a dkv consumer's S^T and dP^T accumulators [64
// x BN] (its kv rows r0 and r0 + 8 against the q tile from row q0; ls the
// tile's LSE in log2 units, then its D; hdr the stage's segment slice,
// sk the thread's kv rows' segments). A pair whose segments differ (a
// mixed tile: the q segments from shared memory against sk) takes
// kSegMask; a q row past Sq, a key past Sk or one above the causal
// diagonal P = 0 (edge tiles only).
template <int BN, bool SEG>
__device__ __forceinline__ void dkv_p_ds(float (&st)[BN / 2],
                                         float (&dpt)[BN / 2],
                                         const float* ls, const int* hdr,
                                         const int (&sk)[2], int q0,
                                         int kv_lo, int r0, int c_off,
                                         int Sq, int Sk, int causal,
                                         float sl2) {
  const bool mix = SEG && hdr[1];
  const int* qid = hdr + kSegHdr;
  const bool edge = (causal && q0 < kv_lo + 64) || q0 + BN > Sq ||
                    kv_lo + 64 > Sk;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int hh = (i >> 1) & 1;
    const int kj = r0 + 8 * hh;
    const int c0 = 8 * (i >> 2) + c_off;     // the pair's first q
    int2 qs = make_int2(0, 0);
    if (mix) qs = *reinterpret_cast<const int2*>(qid + c0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + e;                  // q column
      float y = fmaf(st[i + e], sl2, -ls[c]);
      if (mix && (e ? qs.y : qs.x) != sk[hh]) y = kSegMask - ls[c];
      float p = ex2(y);
      if (edge) {
        const int qi = q0 + c;
        if (qi >= Sq || kj >= Sk || (causal && kj > qi)) p = 0.f;
      }
      st[i + e] = p;                                  // P^T
      dpt[i + e] = p * (dpt[i + e] - ls[BN + c]);     // dS^T
    }
  }
}

template <int D>
using DkvGeo = Geo<D, 128, 64>;              // 128 kv rows; q tiles of 64

template <int D>
constexpr int dkv_smem() {
  using G = DkvGeo<D>;
  // K, V; per stage Q, dO; per stage the q tile's LSE (log2 units) and D;
  // the barriers, the stages' segment slices, the plan's partials, visit
  // and mixed bits
  return 2 * G::M_BYTES + G::STAGES * 2 * G::N_BYTES +
         G::STAGES * 2 * G::BN * 4 + seg_extra<G::BM, G::STAGES, G::BN>() +
         kVisitWords * 4;
}

// dk, dv for k/v [B, Sk, Hk, D] against q, dO [B, Sq, Hq, D]; SEG:
// segment ids seg_q [B, Sq], seg_kv [B, Sk] (the dkv plan, the staged
// slices, kSegMask). Causal needs Sq == Sk. Without ids every q tile is
// visited.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ seg_kv,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int Sq, int Sk, int Hq, int Hk, int causal,
                           float scale) {
  using G = DkvGeo<D>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BM * D;
  unsigned char* ring = smem + 2 * G::M_BYTES;   // stage s: Q, then dO
  float* lsd = reinterpret_cast<float*>(ring + STAGES * 2 * G::N_BYTES);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lsd + STAGES * 2 * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  // stage s's slice: {q0, mixed, -, -} then the tile's BN q segments
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(kv_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));
  uint32_t* mixed = visit + kVisitWords;

  const int k0 = blockIdx.x * BM;              // early keys see the most q
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hk;
  const int q_begin = causal ? k0 : 0;         // k0 is a multiple of BN
  const int n_q = q_begin < Sq ? (Sq - q_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], dkv_full_arrivals(SEG));
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(kv_full, 2 * G::M_BYTES);
    load_tile<G::NB, BM>(Ks, &map_k, kv_full, b, hk, k0);
    load_tile<G::NB, BM>(Vs, &map_v, kv_full, b, hk, k0);
  }
  __syncthreads();
  const int n_vis =
      SEG ? seg_dkv_plan<BM, BN>(seg_q, seg_kv, b, k0, q_begin, Sq, Sk, n_q,
                                 part, visit, mixed)
          : n_q;
  const int total = group * n_vis;             // stages: heads x tiles

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    dkv_produce<BN, STAGES, SEG>(
        [&](int s, int h, int q0) {
          hw::mbar_arrive_expect_tx(&full[s], 2 * G::N_BYTES);
          bf16* Qs = reinterpret_cast<bf16*>(ring + s * 2 * G::N_BYTES);
          load_tile<G::NB, BN>(Qs, &map_q, &full[s], b, h, q0);
          load_tile<G::NB, BN>(Qs + BN * D, &map_do, &full[s], b, h, q0);
        },
        lse, delta, seg_q, lsd, segs, visit, mixed, full, empty, b, hk,
        group, Hq, Sq, q_begin, n_q, total);
  } else {
    hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int kv_lo = k0 + cw * 64;            // this consumer's 64 kv rows
    const int r0 = kv_lo + (t >> 5) * 16 + (lane >> 2);   // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    int sk[2] = {0, 0};                        // this thread's rows' segments
    if (SEG) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        sk[hh] = row < Sk ? seg_kv[static_cast<size_t>(b) * Sk + row] : 0;
      }
    }

    float adk[D / 2], adv[D / 2];              // dK, dV [64 x D]
    bool started = false;
    hw::mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      hw::mbar_wait(&full[s], (it / STAGES) & 1);
      const int* hdr = segs + s * (kSegHdr + BN);
      const int q0 = SEG ? hdr[0] : q_begin + (it % n_q) * BN;
      // every q row of the tile precedes every kv row of this consumer
      if (!(causal && q0 + BN <= kv_lo)) {
        const bf16* Qs =
            reinterpret_cast<const bf16*>(ring + s * 2 * G::N_BYTES);
        const bf16* dOs = Qs + BN * D;
        const float* ls = lsd + s * 2 * BN;
        float st[BN / 2], dpt[BN / 2];         // S^T, dP^T [64 x BN]
        hw::fence_regs(st);
        hw::fence_regs(dpt);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss<0, 0>(st, kmajor<BM>(Ks, cw * 64, kk),
                             kmajor<BN>(Qs, 0, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hw::wgmma_ss<0, 0>(dpt, kmajor<BM>(Vs, cw * 64, kk),
                             kmajor<BN>(dOs, 0, kk), kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(st);
        hw::fence_regs(dpt);

        dkv_p_ds<BN, SEG>(st, dpt, ls, hdr, sk, q0, kv_lo, r0, c_off, Sq, Sk,
                          causal, sl2);
        uint32_t pf[BN / 16][4], dsf[BN / 16][4];   // P^T, dS^T in bf16
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 8 * kk + 2 * x;
            pf[kk][x] = ptt::pack_bf16(st[i], st[i + 1]);
            dsf[kk][x] = ptt::pack_bf16(dpt[i], dpt[i + 1]);
          }
        hw::fence_regs(adv);
        hw::fence_regs(adk);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hw::wgmma_rs<1>(adv, pf[kk], mnmajor<BN>(dOs, kk),
                          started || kk > 0);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hw::wgmma_rs<1>(adk, dsf[kk], mnmajor<BN>(Qs, kk),
                          started || kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(adv);
        hw::fence_regs(adk);
        started = true;
      }
      if (lane == 0) hw::mbar_arrive(&empty[s]);
    }

    // a consumer that visited no tile (every q tile skipped by the plan,
    // or past its rows under causal) writes zeros
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Sk) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sk + row) * Hk + hk) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int i = 4 * jj + 2 * hh;
        *reinterpret_cast<uint32_t*>(dk + base + 8 * jj) =
            started ? ptt::pack_bf16(adk[i] * scale, adk[i + 1] * scale) : 0u;
        *reinterpret_cast<uint32_t*>(dv + base + 8 * jj) =
            started ? ptt::pack_bf16(adv[i], adv[i + 1]) : 0u;
      }
    }
  }
}

// ------------------------------ backward: dq -------------------------------

template <int D>
using DqGeo = Geo<D, 128, 64>;               // 128 q rows; kv tiles of 64

template <int D>
constexpr int dq_smem() {
  using G = DqGeo<D>;
  // Q, dO; per stage K, V; the barriers, the stages' segment slices, the
  // plan's partials and visit bits
  return 2 * G::M_BYTES + G::STAGES * 2 * G::N_BYTES +
         seg_extra<G::BM, G::STAGES, G::BN>();
}

// dS in place of a dq consumer's dP accumulators [64 x BN] (its q rows
// r0 and r0 + 8, from the S accumulators sc, against the kv tile from key
// k0; lse2 / dl the rows' LSE in log2 units and D, sq their segments, hdr
// the stage's segment slice). A pair whose segments differ (a mixed
// tile: the staged kv segments against sq) takes kSegMask; a key past Sk
// or above the causal diagonal P = 0 (edge tiles only).
template <int BN, bool SEG>
__device__ __forceinline__ void dq_ds(const float (&sc)[BN / 2],
                                      float (&dp)[BN / 2], const int* hdr,
                                      const int (&sq)[2],
                                      const float (&lse2)[2],
                                      const float (&dl)[2], int k0,
                                      int row_lo, int r0, int c_off, int Sk,
                                      int causal, float sl2) {
  const bool mix = SEG && hdr[1];
  const int* ids = hdr + kSegHdr;
  const bool edge = (causal && k0 + BN > row_lo) || k0 + BN > Sk;
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int hh = (i >> 1) & 1;
    const int cl = 8 * (i >> 2) + c_off;     // the pair's first key
    int2 ks = make_int2(0, 0);
    if (mix) ks = *reinterpret_cast<const int2*>(ids + cl);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float y = fmaf(sc[i + e], sl2, -lse2[hh]);
      if (mix && (e ? ks.y : ks.x) != sq[hh]) y = kSegMask - lse2[hh];
      float p = ex2(y);
      if (edge) {
        const int kj = k0 + cl + e;
        if (kj >= Sk || (causal && kj > r0 + 8 * hh)) p = 0.f;
      }
      dp[i + e] = p * (dp[i + e] - dl[hh]);  // dS
    }
  }
}

// dq for q, dO [B, Sq, Hq, D] against k/v [B, Sk, Hk, D]; SEG: segment
// ids, walking the kv tiles of seg_plan (the forward's plan at dq's tiles:
// 128 q rows, kv tiles of 64), with the forward's producer (seg_produce)
// and mask. Causal needs Sq == Sk.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_kv,
                          bf16* __restrict__ dq, int Sq, int Sk, int Hq,
                          int Hk, int causal, float scale) {
  using G = DqGeo<D>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BM * D;
  unsigned char* ring = smem + 2 * G::M_BYTES;   // stage s: K, then V
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * 2 * G::N_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(q_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], SEG ? 32 : 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(q_full, 2 * G::M_BYTES);
    load_tile<G::NB, BM>(Qs, &map_q, q_full, b, h, q0);
    load_tile<G::NB, BM>(dOs, &map_do, q_full, b, h, q0);
  }
  __syncthreads();
  int qmm[2] = {0, 0};
  const int n_vis =
      SEG ? seg_plan<BM, BN>(seg_q, seg_kv, b, q0, Sq, Sk, n_kv, part, visit,
                             qmm)
          : n_kv;

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    auto load = [&](int s, int j) {
      bf16* Ks = reinterpret_cast<bf16*>(ring + s * 2 * G::N_BYTES);
      load_tile<G::NB, BN>(Ks, &map_k, &full[s], b, hk, j * BN);
      load_tile<G::NB, BN>(Ks + BN * D, &map_v, &full[s], b, hk, j * BN);
    };
    if (SEG) {
      if (threadIdx.x < 32)
        seg_produce<BN, STAGES>(seg_kv, b, Sk, n_kv, visit, qmm, segs, full,
                                empty, 2 * G::N_BYTES, load);
    } else if (threadIdx.x == 0) {
      produce_all<STAGES>(n_kv, full, empty, 2 * G::N_BYTES, load);
    }
  } else {
    hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int row_lo = q0 + cw * 64;
    const int r0 = row_lo + (t >> 5) * 16 + (lane >> 2);  // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    // this thread's two rows: LSE in log2 units (+inf past Sq: P = 0), D,
    // and their segments
    float lse2[2], dl[2];
    int sq[2] = {0, 0};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + row;
      lse2[hh] = row < Sq ? lse_log2(lse[i]) : INFINITY;
      dl[hh] = row < Sq ? delta[i] : 0.f;
      if (SEG) sq[hh] = row < Sq ? seg_q[static_cast<size_t>(b) * Sq + row] : 0;
    }

    // software-pipelined: tile j's S and dP are issued together with tile
    // j - 1's dQ += dS K, and dS is formed while the latter is in flight.
    // Every branch around a product depends on j alone (ptxas serialises
    // products behind branches it cannot prove uniform), so a consumer
    // runs the fully masked tiles past its rows too, as zeros
    float acc[D / 2];                          // dQ [64 x D]
    float sc[BN / 2], dp[BN / 2];              // S, dP [64 x BN], then dS
    uint32_t dsf[BN / 16][4];                  // dS of the previous tile
    hw::mbar_wait(q_full, 0);
    for (int j = 0; j < n_vis; ++j) {
      const int s = j % STAGES;
      const int sp = (j + STAGES - 1) % STAGES;  // the previous tile's
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
      const int* hdr = segs + s * (kSegHdr + BN);
      const int k0 = SEG ? hdr[0] : j * BN;
      const bf16* Ks = reinterpret_cast<const bf16*>(ring + s * 2 * G::N_BYTES);
      const bf16* Vs = Ks + BN * D;
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hw::wgmma_ss<0, 0>(sc, kmajor<BM>(Qs, cw * 64, kk),
                           kmajor<BN>(Ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hw::wgmma_ss<0, 0>(dp, kmajor<BM>(dOs, cw * 64, kk),
                           kmajor<BN>(Vs, 0, kk), kk > 0);
      hw::wgmma_commit();
      if (j > 0) {
        const bf16* Kp =
            reinterpret_cast<const bf16*>(ring + sp * 2 * G::N_BYTES);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hw::wgmma_rs<1>(acc, dsf[kk], mnmajor<BN>(Kp, kk), j > 1 || kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<1>();
      } else {
        hw::wgmma_wait<0>();
      }
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      dq_ds<BN, SEG>(sc, dp, hdr, sq, lse2, dl, k0, row_lo, r0, c_off, Sk,
                     causal, sl2);
      if (j > 0) {
        hw::wgmma_wait<0>();
        hw::fence_regs(acc);
        if (lane == 0) hw::mbar_arrive(&empty[sp]);   // its K is read
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          dsf[kk][x] = ptt::pack_bf16(dp[8 * kk + 2 * x],
                                      dp[8 * kk + 2 * x + 1]);
    }
    {
      // the last tile's dQ += dS K (n_vis >= 1: q0 < Sq, and the plan
      // visits the tile of some row's own key)
      const int sl = (n_vis - 1) % STAGES;
      const bf16* Kl =
          reinterpret_cast<const bf16*>(ring + sl * 2 * G::N_BYTES);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hw::wgmma_rs<1>(acc, dsf[kk], mnmajor<BN>(Kl, kk), n_vis > 1 || kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Sq) continue;
      bf16* dst =
          dq + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = ptt::pack_bf16(
            acc[4 * jj + 2 * hh] * scale, acc[4 * jj + 2 * hh + 1] * scale);
    }
  }
}

// -------------------------- backward, f32 (3xTF32) -------------------------

// The f32 backward's tiles: NC consumers of 64 resident rows each (BM =
// 64 NC: kv rows in dkv, q rows in dq) against streamed tiles of BN rows
// (q rows in dkv, keys in dq) in a ring of STAGES. Every operand is held
// as tf32 hi and lo parts in shared memory (the resident tiles split
// once, each streamed tile as it lands), and the value-like products'
// operands (Q^T and dO^T in dkv, K^T in dq: tf32 is read K-major only)
// are transposed there too; a transposed tile keeps its 128-byte rows
// (D rows of max(BN, 32) floats).
//   dkv, D = 64: 128 kv rows (K, V hi and lo: 128 KB) against 32-row q
//     tiles (a stage: Q and dO split in place, their lo parts, Q^T and
//     dO^T hi and lo: 64 KB), one stage; D = 128: 64 kv rows (128 KB)
//     against 16-row q tiles (96 KB), one stage.
//   dq, D = 64: 128 q rows (Q, dO hi and lo: 128 KB) against 32-key kv
//     tiles (K and V split in place, their lo parts, K^T hi and lo: 48
//     KB), two stages; D = 128: 64 q rows (128 KB) against 32-key tiles
//     (96 KB), one stage.
template <int D, bool DQ>
struct Tf32BwdGeo {
  static constexpr int NC = D == 64 ? 2 : 1;
  static constexpr int BM = 64 * NC;
  static constexpr int BN = (DQ || D == 64) ? 32 : 16;
  static constexpr int STAGES = (DQ && D == 64) ? 2 : 1;
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int NB = D / 32;                 // 32-float boxes a row
  static constexpr int M_FLOATS = BM * D;           // a resident tile
  static constexpr int N_FLOATS = BN * D;           // a streamed tile
  static constexpr int T_FLOATS = D * (BN < 32 ? 32 : BN);  // transposed
  // dkv: Q, Q lo, dO, dO lo, Q^T hi, lo, dO^T hi, lo; dq: K, K lo, V, V
  // lo, K^T hi, lo
  static constexpr int STAGE_FLOATS =
      4 * N_FLOATS + (DQ ? 2 : 4) * T_FLOATS;
  // the resident hi and lo tiles (dkv: K, V; dq: Q, dO) and the ring
  static constexpr int TILE_BYTES =
      4 * (4 * M_FLOATS + STAGES * STAGE_FLOATS);
};

template <int D>
constexpr int dkv_tf32_smem() {
  using G = Tf32BwdGeo<D, false>;
  // the tiles; per stage the q tile's LSE (log2 units) and D; the
  // barriers, the stages' segment slices, the plan's partials, visit and
  // mixed bits, the alignment slack
  return G::TILE_BYTES + G::STAGES * 2 * G::BN * 4 +
         seg_extra<G::BM, G::STAGES, G::BN>() + kVisitWords * 4;
}

template <int D>
constexpr int dq_tf32_smem() {
  using G = Tf32BwdGeo<D, true>;
  return G::TILE_BYTES + seg_extra<G::BM, G::STAGES, G::BN>();
}

// Split this consumer's 64 rows of a resident f32 tile of BM rows (boxes
// [BM][32 floats]) in place into tf32 hi, and its lo parts into lo (the
// same layout). t: the thread within the consumer.
template <int BM, int D>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int cw,
                                           int t) {
  for (int i = t; i < 64 * D / 4; i += 128) {
    const int nb = i / (64 * 8), r = (i / 8) % 64, ch = i % 8;
    const int at = nb * BM * 32 + (cw * 64 + r) * 32 + ch * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + at);
    float4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + at) = h;
    *reinterpret_cast<float4*>(lo + at) = l;
  }
}

// Split a streamed f32 tile x of BN rows (boxes [BN][32 floats]) in place
// into tf32 hi, its lo parts into lo; with TRANS also into the transposed
// tiles th and tl (D rows, row d holding element (r, d) at position
// vt_pos(r)), so that an accumulator pair of the rows goes to its tf32 A
// fragment as it stands. i0, step: this thread's share of the tile's
// float4s.
template <int BN, int D, bool TRANS>
__device__ __forceinline__ void split_tile(float* x, float* lo, float* th,
                                           float* tl, int i0, int step) {
  for (int i = i0; i < BN * D / 4; i += step) {
    const int r = i % BN, d0 = 4 * (i / BN);
    const int at = f32_at<BN>(r, d0);
    const float4 v = *reinterpret_cast<const float4*>(x + at);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(xs[e], h[e], l[e]);
    *reinterpret_cast<float4*>(x + at) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
    if constexpr (TRANS) {
      const int kap = vt_pos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        th[f32_at<D>(d0 + e, kap)] = h[e];
        tl[f32_at<D>(d0 + e, kap)] = l[e];
      }
    }
  }
}

// acc (+)= A B over D / 8 k8 slices in 3xTF32, both operands K-major in
// shared memory: A's 64 rows from row a0 of hi / lo tiles of AR rows, B's
// BN rows of hi / lo tiles; the small terms first, the sum started
// afresh (scale-d 0).
template <int AR, int BN, int D, int N>
__device__ __forceinline__ void tf32_ss3(float (&acc)[N], const float* ah,
                                         const float* al, int a0,
                                         const float* bh, const float* bl) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    hw::wgmma_tf32_ss(acc, kmajor_f32<AR>(ah, a0, kk),
                      kmajor_f32<BN>(bl, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    hw::wgmma_tf32_ss(acc, kmajor_f32<AR>(al, a0, kk),
                      kmajor_f32<BN>(bh, 0, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    hw::wgmma_tf32_ss(acc, kmajor_f32<AR>(ah, a0, kk),
                      kmajor_f32<BN>(bh, 0, kk), 1);
}

// acc += A B^T-tile over the K / 8 k8 slices of A held in registers as
// tf32 hi / lo fragments (ah, al) against a transposed tile of D rows
// (th, tl), in 3xTF32, small terms first; `first`: the sum starts here.
template <int K, int D, int N>
__device__ __forceinline__ void tf32_rs3(float (&acc)[N],
                                         const uint32_t (&ah)[K / 8][4],
                                         const uint32_t (&al)[K / 8][4],
                                         const float* th, const float* tl,
                                         bool first) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    hw::wgmma_tf32_rs(acc, ah[kk], kmajor_f32<D>(tl, 0, kk),
                      !first || kk > 0);
    hw::wgmma_tf32_rs(acc, al[kk], kmajor_f32<D>(th, 0, kk), 1);
    hw::wgmma_tf32_rs(acc, ah[kk], kmajor_f32<D>(th, 0, kk), 1);
  }
}

// The k8 slice kk of an accumulator tile [64 x N] as the tf32 A fragment
// of the next product over its N columns, split hi + lo: the columns run
// in vt_pos order in the B tile, so the thread's pair (8kk + 2c, + 1) of
// rows g and g + 8 is the fragment's (c, c + 4) as it stands.
template <int N>
__device__ __forceinline__ void tf32_frag(const float (&x)[N / 2], int kk,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float p[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                      x[4 * kk + 3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float h, l;
    split_tf32(p[e], h, l);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(l);
  }
}

// dk, dv (f32) for k/v [B, Sk, Hk, D] against q, dO [B, Sq, Hq, D] in
// 3xTF32: the bf16 dkv's walk, producers and masks (dkv_produce,
// dkv_p_ds: the GQA group's q heads over the visited q tiles; SEG: the
// dkv plan, the staged ids, kSegMask) with every product hi lo + lo hi +
// hi hi. K and V are split
// once (each consumer its own 64 rows); each q tile is split and
// transposed by the consumers together once it lands (Q^T and dO^T are
// dK's and dV's B operands), published by an async-proxy fence and a
// barrier of the consumers. P^T and dS^T are split in registers straight
// from the S^T and dP^T accumulators, never rounded.
template <int D, bool SEG>
__global__ void __launch_bounds__(Tf32BwdGeo<D, false>::THREADS, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ seg_q,
                          const int* __restrict__ seg_kv,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Sk, int Hq, int Hk, int causal,
                          float scale) {
  using G = Tf32BwdGeo<D, false>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES, NC = G::NC;
  constexpr int NT = G::THREADS;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  float* Kh = reinterpret_cast<float*>(smem);
  float* Kl = Kh + G::M_FLOATS;
  float* Vh = Kl + G::M_FLOATS;
  float* Vl = Vh + G::M_FLOATS;
  float* ring = Vl + G::M_FLOATS;
  // stage s: Q, Q lo, dO, dO lo, then Q^T hi, lo, dO^T hi, lo
  auto qtile = [&](int s, int which) {
    return ring + s * G::STAGE_FLOATS + which * G::N_FLOATS;
  };
  auto ttile = [&](int s, int which) {
    return ring + s * G::STAGE_FLOATS + 4 * G::N_FLOATS + which * G::T_FLOATS;
  };
  float* lsd = ring + STAGES * G::STAGE_FLOATS;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(lsd + STAGES * 2 * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(kv_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));
  uint32_t* mixed = visit + kVisitWords;

  const int k0 = blockIdx.x * BM;              // early keys see the most q
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hk;
  const int q_begin = causal ? k0 : 0;         // k0 is a multiple of BN
  const int n_q = q_begin < Sq ? (Sq - q_begin + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], dkv_full_arrivals(SEG));
      hw::mbar_init(&empty[s], 4 * NC);      // one arrival per consumer warp
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(kv_full, 2 * G::M_FLOATS * 4);
    load_tile<G::NB, BM>(Kh, &map_k, kv_full, b, hk, k0);
    load_tile<G::NB, BM>(Vh, &map_v, kv_full, b, hk, k0);
  }
  __syncthreads();
  const int n_vis =
      SEG ? seg_dkv_plan<BM, BN, NT>(seg_q, seg_kv, b, k0, q_begin, Sq, Sk,
                                     n_q, part, visit, mixed)
          : n_q;
  const int total = group * n_vis;             // stages: heads x tiles

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    if constexpr (NC == 2) hw::setmaxnreg_dec<24>();
    dkv_produce<BN, STAGES, SEG>(
        [&](int s, int h, int q0) {
          hw::mbar_arrive_expect_tx(&full[s], 2 * G::N_FLOATS * 4);
          load_tile<G::NB, BN>(qtile(s, 0), &map_q, &full[s], b, h, q0);
          load_tile<G::NB, BN>(qtile(s, 2), &map_do, &full[s], b, h, q0);
        },
        lse, delta, seg_q, lsd, segs, visit, mixed, full, empty, b, hk,
        group, Hq, Sq, q_begin, n_q, total);
  } else {
    if constexpr (NC == 2) hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int kv_lo = k0 + cw * 64;            // this consumer's 64 kv rows
    const int r0 = kv_lo + (t >> 5) * 16 + (lane >> 2);   // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    int sk[2] = {0, 0};                        // this thread's rows' segments
    if (SEG) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + 8 * hh;
        sk[hh] = row < Sk ? seg_kv[static_cast<size_t>(b) * Sk + row] : 0;
      }
    }
    // K and V: this consumer's rows split once
    hw::mbar_wait(kv_full, 0);
    split_rows<BM, D>(Kh, Kl, cw, t);
    split_rows<BM, D>(Vh, Vl, cw, t);

    float adk[D / 2], adv[D / 2];              // dK, dV [64 x D]
    bool started = false;
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      hw::mbar_wait(&full[s], (it / STAGES) & 1);
      // the q tile split and transposed by all the consumers' threads
      split_tile<BN, D, true>(qtile(s, 0), qtile(s, 1), ttile(s, 0),
                              ttile(s, 1), cw * 128 + t, NC * 128);
      split_tile<BN, D, true>(qtile(s, 2), qtile(s, 3), ttile(s, 2),
                              ttile(s, 3), cw * 128 + t, NC * 128);
      hw::fence_proxy_async();
      hw::named_sync(1, NC * 128);
      const int* hdr = segs + s * (kSegHdr + BN);
      const int q0 = SEG ? hdr[0] : q_begin + (it % n_q) * BN;
      // every q row of the tile precedes every kv row of this consumer
      if (!(causal && q0 + BN <= kv_lo)) {
        const float* ls = lsd + s * 2 * BN;
        float st[BN / 2], dpt[BN / 2];         // S^T, dP^T [64 x BN]
        hw::fence_regs(st);
        hw::fence_regs(dpt);
        hw::wgmma_fence();
        tf32_ss3<BM, BN, D>(st, Kh, Kl, cw * 64, qtile(s, 0), qtile(s, 1));
        tf32_ss3<BM, BN, D>(dpt, Vh, Vl, cw * 64, qtile(s, 2), qtile(s, 3));
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(st);
        hw::fence_regs(dpt);

        dkv_p_ds<BN, SEG>(st, dpt, ls, hdr, sk, q0, kv_lo, r0, c_off, Sq, Sk,
                          causal, sl2);
        uint32_t ph[BN / 8][4], pl[BN / 8][4], dh[BN / 8][4], dl[BN / 8][4];
#pragma unroll
        for (int kk = 0; kk < BN / 8; ++kk) {
          tf32_frag<BN>(st, kk, ph[kk], pl[kk]);
          tf32_frag<BN>(dpt, kk, dh[kk], dl[kk]);
        }
        hw::fence_regs(adv);
        hw::fence_regs(adk);
        hw::wgmma_fence();
        tf32_rs3<BN, D>(adv, ph, pl, ttile(s, 2), ttile(s, 3), !started);
        tf32_rs3<BN, D>(adk, dh, dl, ttile(s, 0), ttile(s, 1), !started);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
        hw::fence_regs(adv);
        hw::fence_regs(adk);
        started = true;
      }
      if (lane == 0) hw::mbar_arrive(&empty[s]);
    }

    // a consumer that visited no tile (every q tile skipped by the plan,
    // or past its rows under causal) writes zeros
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Sk) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sk + row) * Hk + hk) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int i = 4 * jj + 2 * hh;
        *reinterpret_cast<float2*>(dk + base + 8 * jj) =
            started ? make_float2(adk[i] * scale, adk[i + 1] * scale)
                    : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(dv + base + 8 * jj) =
            started ? make_float2(adv[i], adv[i + 1]) : make_float2(0.f, 0.f);
      }
    }
  }
}

// dq (f32) for q, dO [B, Sq, Hq, D] against k/v [B, Sk, Hk, D] in
// 3xTF32: the bf16 dq's walk, producer and masks (SEG: seg_plan at these
// tiles, seg_produce, dq_ds) with every product hi lo + lo hi + hi hi,
// without its software pipeline. Q and dO are split once (each consumer
// its own 64 rows); each kv tile is split by the consumers together once
// it lands, K also transposed (dQ += dS K reads K^T, keys in vt_pos
// order). dS is split in registers straight from the accumulators.
template <int D, bool SEG>
__global__ void __launch_bounds__(Tf32BwdGeo<D, true>::THREADS, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv,
                         float* __restrict__ dq, int Sq, int Sk, int Hq,
                         int Hk, int causal, float scale) {
  using G = Tf32BwdGeo<D, true>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES, NC = G::NC;
  constexpr int NT = G::THREADS;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  float* Qh = reinterpret_cast<float*>(smem);
  float* Ql = Qh + G::M_FLOATS;
  float* dOh = Ql + G::M_FLOATS;
  float* dOl = dOh + G::M_FLOATS;
  float* ring = dOl + G::M_FLOATS;
  // stage s: K, K lo, V, V lo, then K^T hi, lo
  auto kvtile = [&](int s, int which) {
    return ring + s * G::STAGE_FLOATS + which * G::N_FLOATS;
  };
  auto ttile = [&](int s, int which) {
    return ring + s * G::STAGE_FLOATS + 4 * G::N_FLOATS + which * G::T_FLOATS;
  };
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * G::STAGE_FLOATS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;
  int* segs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(q_full) + mbar_area(STAGES));
  int* part = segs + STAGES * (kSegHdr + BN);
  uint32_t* visit = reinterpret_cast<uint32_t*>(part + 4 * (BM / 32));

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], SEG ? 32 : 1);
      hw::mbar_init(&empty[s], 4 * NC);
    }
    hw::fence_barrier_init();
    hw::mbar_arrive_expect_tx(q_full, 2 * G::M_FLOATS * 4);
    load_tile<G::NB, BM>(Qh, &map_q, q_full, b, h, q0);
    load_tile<G::NB, BM>(dOh, &map_do, q_full, b, h, q0);
  }
  __syncthreads();
  int qmm[2] = {0, 0};
  const int n_vis =
      SEG ? seg_plan<BM, BN, NT>(seg_q, seg_kv, b, q0, Sq, Sk, n_kv, part,
                                 visit, qmm)
          : n_kv;

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    if constexpr (NC == 2) hw::setmaxnreg_dec<24>();
    auto load = [&](int s, int j) {
      load_tile<G::NB, BN>(kvtile(s, 0), &map_k, &full[s], b, hk, j * BN);
      load_tile<G::NB, BN>(kvtile(s, 2), &map_v, &full[s], b, hk, j * BN);
    };
    if (SEG) {
      if (threadIdx.x < 32)
        seg_produce<BN, STAGES>(seg_kv, b, Sk, n_kv, visit, qmm, segs, full,
                                empty, 2 * G::N_FLOATS * 4, load);
    } else if (threadIdx.x == 0) {
      produce_all<STAGES>(n_kv, full, empty, 2 * G::N_FLOATS * 4, load);
    }
  } else {
    if constexpr (NC == 2) hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int row_lo = q0 + cw * 64;
    const int r0 = row_lo + (t >> 5) * 16 + (lane >> 2);  // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;
    // this thread's two rows: LSE in log2 units (+inf past Sq: P = 0), D,
    // and their segments
    float lse2[2], dl[2];
    int sq[2] = {0, 0};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + row;
      lse2[hh] = row < Sq ? lse_log2(lse[i]) : INFINITY;
      dl[hh] = row < Sq ? delta[i] : 0.f;
      if (SEG) sq[hh] = row < Sq ? seg_q[static_cast<size_t>(b) * Sq + row] : 0;
    }
    // Q and dO: this consumer's rows split once
    hw::mbar_wait(q_full, 0);
    split_rows<BM, D>(Qh, Ql, cw, t);
    split_rows<BM, D>(dOh, dOl, cw, t);

    // Every branch around a product depends on j alone, so a consumer
    // runs the fully masked tiles past its rows too, as zeros
    float acc[D / 2];                          // dQ [64 x D]
    for (int j = 0; j < n_vis; ++j) {
      const int s = j % STAGES;
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
      split_tile<BN, D, true>(kvtile(s, 0), kvtile(s, 1), ttile(s, 0),
                              ttile(s, 1), cw * 128 + t, NC * 128);
      split_tile<BN, D, false>(kvtile(s, 2), kvtile(s, 3), nullptr, nullptr,
                               cw * 128 + t, NC * 128);
      hw::fence_proxy_async();
      hw::named_sync(1, NC * 128);
      const int* hdr = segs + s * (kSegHdr + BN);
      const int k0 = SEG ? hdr[0] : j * BN;
      float sc[BN / 2], dp[BN / 2];            // S, dP [64 x BN], then dS
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      hw::wgmma_fence();
      tf32_ss3<BM, BN, D>(sc, Qh, Ql, cw * 64, kvtile(s, 0), kvtile(s, 1));
      tf32_ss3<BM, BN, D>(dp, dOh, dOl, cw * 64, kvtile(s, 2), kvtile(s, 3));
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(sc);
      hw::fence_regs(dp);
      dq_ds<BN, SEG>(sc, dp, hdr, sq, lse2, dl, k0, row_lo, r0, c_off, Sk,
                     causal, sl2);
      uint32_t dh[BN / 8][4], dlo[BN / 8][4];
#pragma unroll
      for (int kk = 0; kk < BN / 8; ++kk) tf32_frag<BN>(dp, kk, dh[kk], dlo[kk]);
      hw::fence_regs(acc);
      hw::wgmma_fence();
      tf32_rs3<BN, D>(acc, dh, dlo, ttile(s, 0), ttile(s, 1), j == 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      if (lane == 0) hw::mbar_arrive(&empty[s]);
    }

    // (n_vis >= 1: q0 < Sq, and the plan visits the tile of some row's
    // own key)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= Sq) continue;
      float* dst =
          dq + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(
            acc[4 * jj + 2 * hh] * scale, acc[4 * jj + 2 * hh + 1] * scale);
    }
  }
}

// -------------------------------- launch -----------------------------------

template <class K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// 0 = launch, -1 = nothing to do, else the error to return: q [B, Sq,
// Hq, D] against k/v [B, Sk, Hk, D], seg_q / seg_kv both given or both
// null; causal needs Sq == Sk
int check_shape(int B, int Sq, int Sk, int Hq, int Hk, int D, int causal,
                const int* seg_q, const int* seg_kv) {
  if (B <= 0 || Sq <= 0 || Sk <= 0) return -1;
  if (Hk <= 0 || Hq % Hk != 0 || (D != 64 && D != 128) ||
      (causal && Sq != Sk) || ((seg_q == nullptr) != (seg_kv == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the forwards' shape: q [B, Sq, Hq, D], k/v [B, Sk, Hk, D]; seg_q /
// seg_kv int32 [B, Sq] / [B, Sk] or both null
struct FwdArgs {
  const void *q, *k, *v;
  const int *seg_q, *seg_kv;
  void *o, *lse;
  int B, Sq, Sk, Hq, Hk, D, causal;
  float scale;
};

// bf16 (EB = 2) on flash_fwd_wgmma_kernel, f32 (EB = 4) on
// flash_fwd_tf32_kernel; the segment instantiation when ids are given
template <int D, int EB, bool SEG>
int fwd_launch(const FwdArgs& a, cudaStream_t stream) {
  constexpr bool F32 = EB == 4;
  constexpr int BM = F32 ? F32Geo<D>::BM : FwdGeo<D>::BM;
  constexpr int BN = F32 ? F32Geo<D>::BN : FwdGeo<D>::BN;
  constexpr int smem = F32 ? fwd_f32_smem<D>() : fwd_smem<D>();
  CUtensorMap mq, mk, mv;
  int err = hw::tma_map_bshd(&mq, a.q, a.B, a.Sq, a.Hq, D, BM, EB);
  if (err == 0) err = hw::tma_map_bshd(&mk, a.k, a.B, a.Sk, a.Hk, D, BN, EB);
  if (err == 0) err = hw::tma_map_bshd(&mv, a.v, a.B, a.Sk, a.Hk, D, BN, EB);
  if (err != 0) return err;
  dim3 grid((a.Sq + BM - 1) / BM, a.Hq, a.B);
  cudaError_t e;
  if constexpr (F32) {
    e = prepare(flash_fwd_tf32_kernel<D, SEG>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_tf32_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, a.seg_q, a.seg_kv, static_cast<float*>(a.o),
        static_cast<float*>(a.lse), a.Sq, a.Sk, a.Hq, a.Hk, a.causal,
        a.scale);
  } else {
    e = prepare(flash_fwd_wgmma_kernel<D, SEG>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_wgmma_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
        mq, mk, mv, a.seg_q, a.seg_kv, static_cast<bf16*>(a.o),
        static_cast<float*>(a.lse), a.Sq, a.Sk, a.Hq, a.Hk, a.causal,
        a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int EB>
int fwd_any(const FwdArgs& a, void* stream) {
  const int c = check_shape(a.B, a.Sq, a.Sk, a.Hq, a.Hk, a.D, a.causal,
                            a.seg_q, a.seg_kv);
  if (c != 0) return c < 0 ? 0 : c;
  auto st = static_cast<cudaStream_t>(stream);
  const bool seg = a.seg_q != nullptr;
  if (a.D == 64)
    return seg ? fwd_launch<64, EB, true>(a, st) : fwd_launch<64, EB, false>(a, st);
  return seg ? fwd_launch<128, EB, true>(a, st) : fwd_launch<128, EB, false>(a, st);
}

// A FULL bias as a TMA map for the stats kernel: dims {Sk, Sq, H or 1, B
// or 1} (a dimension the bias is broadcast along kept at size 1), boxes
// of [128 rows][32 keys] f32 with the 128-byte swizzle (stats_produce,
// bias_at). Returns 0, or nonzero where TMA cannot read it (the key
// stride not 1, another stride or the base not whole 16-byte vectors, or
// the encoder refusing).
inline int stats_bias_map(CUtensorMap* map, const float* bias, int B, int Sq,
                          int Sk, int H, long long sb, long long sh,
                          long long sq, long long sk) {
  if (sk != 1 || sq <= 0 || sq % 4 || sh % 4 || sb % 4 || sh < 0 || sb < 0 ||
      reinterpret_cast<uintptr_t>(bias) % 16)
    return 1;
  hw::EncodeTiledFn fn = hw::encode_tiled();
  if (fn == nullptr) return 1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Sk),
                              static_cast<cuuint64_t>(Sq),
                              static_cast<cuuint64_t>(sh ? H : 1),
                              static_cast<cuuint64_t>(sb ? B : 1)};
  // a size-1 dimension's stride is never stepped: give it the packed one
  const long long s2 = sh ? sh : sq * Sq, s3 = sb ? sb : s2 * (sh ? H : 1);
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sq * 4),
                                 static_cast<cuuint64_t>(s2 * 4),
                                 static_cast<cuuint64_t>(s3 * 4)};
  const cuuint32_t box[4] = {32, kStatsBM, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return static_cast<int>(fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(bias),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// the block-stats mode (block_stats_wgmma_kernel<D, FULL>): q [B, Sq, H,
// D] and k/v [B, Sk, H, D] bf16, the grid (B, bands, H)
template <int D, bool FULL>
int stats_launch(const void* q, const void* k, const void* v,
                 const CUtensorMap& map_bias, const StatsArgs& sa, int B,
                 int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  using G = StatsGeo<D, FULL>;
  CUtensorMap mq, mk, mv;
  int err = hw::tma_map_bshd(&mq, q, B, Sq, H, D, G::BM);
  if (err == 0) err = hw::tma_map_bshd(&mk, k, B, Sk, H, D, G::BN);
  if (err == 0) err = hw::tma_map_bshd(&mv, v, B, Sk, H, D, G::BN);
  if (err != 0) return err;
  constexpr int smem = stats_smem<D, FULL>();
  cudaError_t e = prepare(block_stats_wgmma_kernel<D, FULL>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(B, (Sq + G::BM - 1) / G::BM, H);
  block_stats_wgmma_kernel<D, FULL><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, map_bias, sa, Sq, Sk, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// the backwards' shape: q, dout [B, Sq, Hq, D], k/v [B, Sk, Hk, D], lse
// and delta f32 [B, Hq, Sq]; seg_q / seg_kv as the forward's; the outputs
// dq (q's shape), dk and dv (k's), each null where its launch does not run
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg_q, *seg_kv;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hk, D, causal;
  float scale;
};

template <int D, bool SEG>
int dkv_launch(const BwdArgs& a, cudaStream_t stream) {
  using G = DkvGeo<D>;
  // the q tiles stream (box BN rows of Sq), the kv tile stays (box BM
  // rows of Sk)
  CUtensorMap mq, mdo, mk, mv;
  int err = hw::tma_map_bshd(&mq, a.q, a.B, a.Sq, a.Hq, D, G::BN);
  if (err == 0) err = hw::tma_map_bshd(&mdo, a.dout, a.B, a.Sq, a.Hq, D, G::BN);
  if (err == 0) err = hw::tma_map_bshd(&mk, a.k, a.B, a.Sk, a.Hk, D, G::BM);
  if (err == 0) err = hw::tma_map_bshd(&mv, a.v, a.B, a.Sk, a.Hk, D, G::BM);
  if (err != 0) return err;
  constexpr int smem = dkv_smem<D>();
  cudaError_t e = prepare(flash_bwd_dkv_wgmma_kernel<D, SEG>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + G::BM - 1) / G::BM, a.Hk, a.B);
  flash_bwd_dkv_wgmma_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.Hq,
      a.Hk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SEG>
int dq_launch(const BwdArgs& a, cudaStream_t stream) {
  using G = DqGeo<D>;
  // the q tile stays (box BM rows of Sq), the kv tiles stream (box BN
  // rows of Sk)
  CUtensorMap mq, mdo, mk, mv;
  int err = hw::tma_map_bshd(&mq, a.q, a.B, a.Sq, a.Hq, D, G::BM);
  if (err == 0) err = hw::tma_map_bshd(&mdo, a.dout, a.B, a.Sq, a.Hq, D, G::BM);
  if (err == 0) err = hw::tma_map_bshd(&mk, a.k, a.B, a.Sk, a.Hk, D, G::BN);
  if (err == 0) err = hw::tma_map_bshd(&mv, a.v, a.B, a.Sk, a.Hk, D, G::BN);
  if (err != 0) return err;
  constexpr int smem = dq_smem<D>();
  cudaError_t e = prepare(flash_bwd_dq_wgmma_kernel<D, SEG>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + G::BM - 1) / G::BM, a.Hq, a.B);
  flash_bwd_dq_wgmma_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv,
      static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SEG>
int dkv_tf32_launch(const BwdArgs& a, cudaStream_t stream) {
  using G = Tf32BwdGeo<D, false>;
  CUtensorMap mq, mdo, mk, mv;
  int err = hw::tma_map_bshd(&mq, a.q, a.B, a.Sq, a.Hq, D, G::BN, 4);
  if (err == 0) err = hw::tma_map_bshd(&mdo, a.dout, a.B, a.Sq, a.Hq, D, G::BN, 4);
  if (err == 0) err = hw::tma_map_bshd(&mk, a.k, a.B, a.Sk, a.Hk, D, G::BM, 4);
  if (err == 0) err = hw::tma_map_bshd(&mv, a.v, a.B, a.Sk, a.Hk, D, G::BM, 4);
  if (err != 0) return err;
  constexpr int smem = dkv_tf32_smem<D>();
  cudaError_t e = prepare(flash_bwd_dkv_tf32_kernel<D, SEG>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sk + G::BM - 1) / G::BM, a.Hk, a.B);
  flash_bwd_dkv_tf32_kernel<D, SEG><<<grid, G::THREADS, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk, a.Hq,
      a.Hk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool SEG>
int dq_tf32_launch(const BwdArgs& a, cudaStream_t stream) {
  using G = Tf32BwdGeo<D, true>;
  CUtensorMap mq, mdo, mk, mv;
  int err = hw::tma_map_bshd(&mq, a.q, a.B, a.Sq, a.Hq, D, G::BM, 4);
  if (err == 0) err = hw::tma_map_bshd(&mdo, a.dout, a.B, a.Sq, a.Hq, D, G::BM, 4);
  if (err == 0) err = hw::tma_map_bshd(&mk, a.k, a.B, a.Sk, a.Hk, D, G::BN, 4);
  if (err == 0) err = hw::tma_map_bshd(&mv, a.v, a.B, a.Sk, a.Hk, D, G::BN, 4);
  if (err != 0) return err;
  constexpr int smem = dq_tf32_smem<D>();
  cudaError_t e = prepare(flash_bwd_dq_tf32_kernel<D, SEG>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.Sq + G::BM - 1) / G::BM, a.Hq, a.B);
  flash_bwd_dq_tf32_kernel<D, SEG><<<grid, G::THREADS, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, a.seg_q, a.seg_kv,
      static_cast<float*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 (EB = 2) on the wgmma kernels, f32 (EB = 4) on their 3xTF32 form
template <int D, int EB, bool SEG>
int dkv_any(const BwdArgs& a, cudaStream_t st) {
  if constexpr (EB == 4) return dkv_tf32_launch<D, SEG>(a, st);
  else return dkv_launch<D, SEG>(a, st);
}

template <int D, int EB, bool SEG>
int dq_any(const BwdArgs& a, cudaStream_t st) {
  if constexpr (EB == 4) return dq_tf32_launch<D, SEG>(a, st);
  else return dq_launch<D, SEG>(a, st);
}

// the dkv launch, then the dq launch, of what a.dk / a.dq ask for; the
// segment instantiations when ids are given
template <int EB>
int bwd_any(const BwdArgs& a, void* stream) {
  const int c = check_shape(a.B, a.Sq, a.Sk, a.Hq, a.Hk, a.D, a.causal,
                            a.seg_q, a.seg_kv);
  if (c != 0) return c < 0 ? 0 : c;
  auto st = static_cast<cudaStream_t>(stream);
  const bool seg = a.seg_q != nullptr;
  int err = 0;
  if (a.dk != nullptr) {
    if (a.D == 64)
      err = seg ? dkv_any<64, EB, true>(a, st) : dkv_any<64, EB, false>(a, st);
    else
      err = seg ? dkv_any<128, EB, true>(a, st)
                : dkv_any<128, EB, false>(a, st);
  }
  if (err != 0 || a.dq == nullptr) return err;
  if (a.D == 64)
    return seg ? dq_any<64, EB, true>(a, st) : dq_any<64, EB, false>(a, st);
  return seg ? dq_any<128, EB, true>(a, st) : dq_any<128, EB, false>(a, st);
}

template <typename T>
int delta_any(const void* o, const void* dout, void* delta, int B, int S,
              int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * S * H;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = rows * (D / ptt::Vec<T>::N);
  const int grid = static_cast<int>((threads + 255) / 256);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    flash_delta_kernel<T, 64><<<grid, 256, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout),
        static_cast<float*>(delta), static_cast<int>(rows), S, H);
  else
    flash_delta_kernel<T, 128><<<grid, 256, 0, st>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout),
        static_cast<float*>(delta), static_cast<int>(rows), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- the one-length route (q and kv of one length, no ids: LLaMA
// training, ERNIE's encoder, sdpa without a mask): bf16 on the wgmma
// core, f32 on its 3xTF32 form ----

#define PTT_ONE_LENGTH_ENTRIES(SUFFIX, EB)                                    \
  extern "C" int ptt_flash_attention_fwd_##SUFFIX(                            \
      const void* q, const void* k, const void* v, void* o, void* lse, int B, \
      int S, int Hq, int Hk, int D, int causal, float scale, void* stream) {  \
    return fwd_any<EB>(FwdArgs{q, k, v, nullptr, nullptr, o, lse, B, S, S,    \
                               Hq, Hk, D, causal, scale},                     \
                       stream);                                               \
  }                                                                           \
  /* dkv, then dq, from the delta pre-pass's D */                             \
  extern "C" int ptt_flash_attention_bwd_##SUFFIX(                            \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, void* dk, void* dv,       \
      int B, int S, int Hq, int Hk, int D, int causal, float scale,           \
      void* stream) {                                                         \
    return bwd_any<EB>(BwdArgs{q, k, v, dout, static_cast<const float*>(lse), \
                               static_cast<const float*>(delta), nullptr,     \
                               nullptr, dq, dk, dv, B, S, S, Hq, Hk, D,       \
                               causal, scale},                                \
                       stream);                                               \
  }

PTT_ONE_LENGTH_ENTRIES(bf16, 2)
PTT_ONE_LENGTH_ENTRIES(f32, 4)

#undef PTT_ONE_LENGTH_ENTRIES

// ---- the segment route (padding masks, packed documents, q and kv
// lengths of their own): q [B, Sq, Hq, D], k/v [B, Sk, Hk, D], seg_q /
// seg_kv int32 [B, Sq] / [B, Sk] (both or neither). Forward, dkv and dq
// (the backward from the delta pre-pass's D): bf16 on the wgmma core,
// f32 on its 3xTF32 form. ----

extern "C" int ptt_flash_attention_seg_fwd_bf16(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, void* o, void* lse, int B, int Sq, int Sk, int Hq,
    int Hk, int D, int causal, float scale, void* stream) {
  return fwd_any<2>(FwdArgs{q, k, v, static_cast<const int*>(seg_q),
                            static_cast<const int*>(seg_kv), o, lse, B, Sq,
                            Sk, Hq, Hk, D, causal, scale},
                    stream);
}

extern "C" int ptt_flash_attention_seg_fwd_f32(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* seg_kv, void* o, void* lse, int B, int Sq, int Sk, int Hq,
    int Hk, int D, int causal, float scale, void* stream) {
  return fwd_any<4>(FwdArgs{q, k, v, static_cast<const int*>(seg_q),
                            static_cast<const int*>(seg_kv), o, lse, B, Sq,
                            Sk, Hq, Hk, D, causal, scale},
                    stream);
}

#define PTT_SEG_BWD_ENTRIES(SUFFIX, EB)                                       \
  extern "C" int ptt_flash_attention_seg_dkv_##SUFFIX(                        \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, const void* seg_q,                  \
      const void* seg_kv, void* dk, void* dv, int B, int Sq, int Sk, int Hq,  \
      int Hk, int D, int causal, float scale, void* stream) {                 \
    return bwd_any<EB>(BwdArgs{q, k, v, dout, static_cast<const float*>(lse), \
                               static_cast<const float*>(delta),              \
                               static_cast<const int*>(seg_q),                \
                               static_cast<const int*>(seg_kv), nullptr, dk,  \
                               dv, B, Sq, Sk, Hq, Hk, D, causal, scale},      \
                       stream);                                               \
  }                                                                           \
  extern "C" int ptt_flash_attention_seg_dq_##SUFFIX(                         \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, const void* seg_q,                  \
      const void* seg_kv, void* dq, int B, int Sq, int Sk, int Hq, int Hk,    \
      int D, int causal, float scale, void* stream) {                         \
    return bwd_any<EB>(BwdArgs{q, k, v, dout, static_cast<const float*>(lse), \
                               static_cast<const float*>(delta),              \
                               static_cast<const int*>(seg_q),                \
                               static_cast<const int*>(seg_kv), dq, nullptr,  \
                               nullptr, B, Sq, Sk, Hq, Hk, D, causal, scale}, \
                       stream);                                               \
  }

PTT_SEG_BWD_ENTRIES(bf16, 2)
PTT_SEG_BWD_ENTRIES(f32, 4)

#undef PTT_SEG_BWD_ENTRIES

// ---- the block-stats kernel's bf16 route (kernels/block_attention.py;
// its f32 route is block_attention.cu): q [B, Sq, H, D], k/v [B, Sk, H,
// D] bf16; mask uint8 rows of mask_ld bytes (a multiple of 16, >= Sk) or
// null, with its scratch: bits [ceil(Sk / 64)][bands * 128] 64-bit words
// and tiles [bands][ceil(Sk / 64)] bytes (bands = ceil(Sq / 128)); bias
// f32 read at bias[b sb + h sh + i sq + j sk] or null; m, l [B, H, Sq] and
// o [B, Sq, H, D] f32 out. With a mask, the mask's bits and tile classes
// first (stats_mask_bits_kernel), then the stats kernel ----

extern "C" int ptt_block_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, void* m, void* l, void* o, void* bits, void* tiles,
    int B, int Sq, int Sk, int H, int D, int mask_ld, long long sb,
    long long sh, long long sq, long long sk, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || (D != 64 && D != 128) ||
      (mask != nullptr &&
       (mask_ld < Sk || mask_ld % 16 != 0 || bits == nullptr ||
        tiles == nullptr || reinterpret_cast<uintptr_t>(mask) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(bits) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Sk + kStatsBN - 1) / kStatsBN;
  const int bands = (Sq + kStatsBM - 1) / kStatsBM;
  if (mask != nullptr) {
    stats_mask_bits_kernel<<<dim3(n_tiles, bands), kStatsBM, 0, st>>>(
        static_cast<const unsigned char*>(mask), mask_ld, Sq, Sk,
        static_cast<uint64_t*>(bits), bands * kStatsBM,
        static_cast<unsigned char*>(tiles));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* bp = static_cast<const float*>(bias);
  const bool full = bias != nullptr && sq != 0 && sk != 0;
  CUtensorMap map_bias{};
  const bool tma =
      full && stats_bias_map(&map_bias, bp, B, Sq, Sk, H, sb, sh, sq, sk) == 0;
  const StatsArgs sa{mask ? static_cast<const uint64_t*>(bits) : nullptr,
                     mask ? static_cast<const unsigned char*>(tiles) : nullptr,
                     bp, sb, sh, sq, sk,
                     static_cast<float*>(m), static_cast<float*>(l),
                     static_cast<float*>(o), n_tiles, bands * kStatsBM, tma};
  if (full)
    return D == 64 ? stats_launch<64, true>(q, k, v, map_bias, sa, B, Sq, Sk,
                                            H, scale, st)
                   : stats_launch<128, true>(q, k, v, map_bias, sa, B, Sq, Sk,
                                             H, scale, st);
  return D == 64 ? stats_launch<64, false>(q, k, v, map_bias, sa, B, Sq, Sk, H,
                                           scale, st)
                 : stats_launch<128, false>(q, k, v, map_bias, sa, B, Sq, Sk,
                                            H, scale, st);
}

// D = rowsum(dout * o) in f32: o, dout BSHD [B, S, H, D] -> delta [B, H, S]
extern "C" int ptt_flash_attention_delta_bf16(const void* o, const void* dout,
                                              void* delta, int B, int S,
                                              int H, int D, void* stream) {
  return delta_any<bf16>(o, dout, delta, B, S, H, D, stream);
}

extern "C" int ptt_flash_attention_delta_f32(const void* o, const void* dout,
                                             void* delta, int B, int S, int H,
                                             int D, void* stream) {
  return delta_any<float>(o, dout, delta, B, S, H, D, stream);
}
