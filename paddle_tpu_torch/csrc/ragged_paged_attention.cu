// Ragged paged attention: packed prefill-chunk and decode rows of every
// sequence attend causally, in ONE launch, to their KV held in the
// shared page pool [kvh, n_pages, page, d] (any outer strides, unit
// stride along d) through a per-sequence block table. Row t of sequence
// s sits at absolute position kv_len[s] - q_len[s] + (t - q_start[s]);
// GQA reads KV head h / rep.
//
// Replaces: paddle_tpu/kernels/ragged_paged_attention.py::
//   ragged_paged_attention (l.266: _pallas_path -> kern, whose grid
//   walked (seq, head, q_block, kv_page) with the page gather in a
//   scalar-prefetch index map).
// Bound on the H100: bytes — the KV pages read (a decode row does 4
//   flops per KV byte in bf16; the ragged step's 0.7 GFLOP take 0.7 us at
//   the bf16 tensor-core rate against its 5.8 us of bytes), plus q and
//   out once. Tensor cores pay here by cutting each row's serial
//   instruction stream, not for their rate.
// Design: split-KV over tiles, the schedule and merge of
//   paged_split.cuh, shared with paged_attention.cu. A sequence's rows
//   are taken per kv head with its rep q heads packed in (packed row r =
//   local row r / rep, head r % rep), so a K/V row is read once per kv
//   head, and cut into tiles: in bf16 a sequence of more than WALK_ROWS
//   packed rows takes 64-row tensor-core tiles (4 warps x 16 rows), any
//   other sequence (a decode row, a short chunk) and every f32 sequence
//   8-row walk tiles. A tile's keys, up to its last row's causal limit,
//   are cut into splits (a fixed run of pages; SPLIT_KEYS of
//   kernels/_paged_split.py, shared with paged_attention.cu), each split
//   one work item of one block; a tile with one split writes its rows
//   directly, otherwise the last split to arrive merges the partials in
//   split order. The grid is persistent: every block computes the
//   schedule (tiles and live splits per sequence, prefix sums) from the
//   metadata and takes items blockIdx.x, + gridDim.x, ... of the
//   (item, kv head) list, so no block is launched for a tile or split
//   that does not exist; the grid is the card's resident blocks or
//   fewer. Every block also writes zeros to its share of the rows no
//   sequence owns: the output is written wholly by the kernel (the
//   wrapper allocates it with torch.empty).
//   Tensor-core tile: S = Q K^T and O += P V on mma.sync.m16n8k16
//   (attention_tiles.cuh), online softmax on the fragments (log2
//   domain) with the causal limit kv_len - q_len + row and kv_len
//   masking the last tile. Q comes in by cp.async and is pre-scaled in
//   shared memory; K and V are gathered as whole pages through the block
//   table (staged per split in shared memory) by 16-byte cp.async into
//   64-key tiles, double-buffered. P enters the PV product as two bf16
//   parts (hi + lo), so the product keeps P to about 2^-16 and the
//   output holds the plain version's element limit (one bf16 rounding
//   of an f32 result); P rounded once to bf16 would miss it wherever
//   |o| is small beside sum p |v| / l.
//   Walk tile: the decode walk of paged_split.cuh (lanes over d, keys
//   over warps and splits), not a 16-row tensor tile that is 15/16 empty
//   with three warps idle. f32 is on no serving path: it stays on the
//   walk (SIMT) at every row count.
//   Row tiles: a sequence flagged in row_tiles (the engine's decode and
//   speculative verify entries) is cut per local row: each row's rep
//   packed rows form a group tiled exactly as a q_len = 1 sequence's, so
//   each row reads its own keys up to its own causal limit, in its own
//   splits, on the tile kind and walk width of a decode row, and its
//   output is bitwise what that row gives as a decode row (the walk's
//   unroll and the split count otherwise follow the tile's row count and
//   last row). The cost is one read of the keys a row.
//   Split size: 256 keys for both tile kinds, from chip_smoke.py's
//   sweep on the H100 at the serving step's mixed and decode-only cases
//   (PERF.md, PR 13). Shorter splits put more blocks on the long walks
//   but each adds a block's fixed cost (schedule, page ids, ticket) and
//   merge work, and the persistent grid holds two blocks an SM (the
//   tensor tile's 87 KB of shared memory), so more items than that wait
//   for a second turn.
//   The first design ran a (16-row q block, q head, sequence) grid
//   whose rows walked their keys one at a time with shuffled dot
//   products, a decode row on one warp of four, and re-read K and V per
//   q head; its wrapper zero-filled the output with a memset launch.
//   q is pre-scaled in q's own dtype before the f32 math (the reference
//   fallback's float order, which greedy ties depend on). Requires page
//   in {8, 16, 32, 64}, d in {64, 128}.

#include <math.h>

#include "attention_tiles.cuh"
#include "common.cuh"
#include "paged_split.cuh"

namespace {

namespace pg = ptt::paged;
using ptt::attn::bf16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_ROWS = 64;   // rows of a tensor-core tile: 4 warps x 16
constexpr int WALK_ROWS = 8;    // rows of a walk tile
constexpr int KT = 64;          // keys per shared-memory K/V tile

// Q, two K and two V tiles, rows padded
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 5 * TILE_ROWS * (D + 8) * 2;
}

// the walk's s_m, s_l, s_acc, res_m, res_l
template <int D>
__host__ __device__ constexpr int walk_bytes() {
  return 4 * (2 * WARPS * WALK_ROWS + WARPS * WALK_ROWS * D + 2 * WALK_ROWS);
}

// the shared-memory bytes before the job buffers: the schedule (q_start,
// q_len, kv_len, row-tile flags, item and tile prefixes), the tile's row
// ids and the split's page ids
__host__ __device__ inline int head_bytes(int B, int np_max) {
  return ptt::attn::align128(4 * (4 * B + 2 * (B + 1) + TILE_ROWS + np_max));
}

// the job buffers: a tensor-core tile's or a walk's, and then, over
// them, the merge's weights (the last block merges once its own job's
// buffers are spent)
template <typename T, int D>
__host__ __device__ constexpr int job_bytes() {
  constexpr int job = sizeof(T) == 2 ? tile_bytes<D>() : walk_bytes<D>();
  constexpr int merge = 8 * pg::MAX_SPLITS * TILE_ROWS;
  return job > merge ? job : merge;
}

__device__ __forceinline__ int rows_per_tile(bool tc, int nrows) {
  return tc && nrows > WALK_ROWS ? TILE_ROWS : WALK_ROWS;
}

// How a sequence's q_len * rep packed rows are cut: into groups of gs rows
// (all of them, or one local row's rep when the sequence is flagged in
// row_tiles), each group into tpg tiles of rpt rows.
struct Tiling {
  int gs, rpt, tpg, tiles;
  __device__ Tiling(bool tc, bool own, int ql, int rep) {
    const int nrows = max(ql, 0) * rep;
    gs = own ? rep : nrows;
    rpt = rows_per_tile(tc, gs);
    tpg = (gs + rpt - 1) / rpt;
    tiles = nrows > 0 ? (own ? ql : 1) * tpg : 0;
  }
  // tile k's packed rows [r0, r1)
  __device__ __forceinline__ void rows(int k, int& r0, int& r1) const {
    const int g0 = k / tpg * gs;
    r0 = g0 + k % tpg * rpt;
    r1 = min(r0 + rpt, g0 + gs);
  }
};

// keys a tile whose last packed row is r1 - 1 needs: that row's causal
// limit, cut to kv_len and to the block table (kcap)
__device__ __forceinline__ int tile_kend(int r1, int rep, int ctx, int kcap) {
  return min(kcap, ctx + (r1 - 1) / rep + 1);
}

// one split of one tile: what the tile and walk jobs share
struct Job {
  const int* rows;      // [rpt] row ids t * nh + h of out and q, or -1
  int nr;               // rows of this tile
  int r0;               // the tile's first packed row
  int rep, ctx, kcap;   // row r's keys: [0, min(kcap, ctx + (r0+r)/rep + 1))
  int k0, k1;           // this split's keys
  const int* pages;     // page ids of keys k0.. (shared memory)
  int z, n_live, R;     // split, live splits of the tile, rows of out
  int* ticket;
};

// the hi and lo bf16 parts of P's accumulators (n8 tiles 2j, 2j+1) as
// A fragments: P = hi + lo to about 2^-16
__device__ __forceinline__ void split_p(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r0[i] = c0[i] - __bfloat162float(__float2bfloat16(c0[i]));
    r1[i] = c1[i] - __bfloat162float(__float2bfloat16(c1[i]));
  }
  ptt::attn::acc_to_a(hi, c0, c1);
  ptt::attn::acc_to_a(lo, r0, r1);
}

// A tensor-core tile (bf16): up to 64 rows, each warp 16, over one split.
template <int D>
__device__ __forceinline__ void tile_job(
    const Job j, const bf16* __restrict__ q, const bf16* __restrict__ kbase,
    const bf16* __restrict__ vbase, int page, long long s_page,
    long long s_tok, float scale, unsigned char* big, float* part_o,
    float2* part_ml, bf16* __restrict__ out) {
  constexpr int LD = D + 8;               // padded rows: ldmatrix, no conflicts
  constexpr int VPR = D / 8;              // 16-byte vectors per row
  bf16* Qs = reinterpret_cast<bf16*>(big);
  bf16* Ks = Qs + TILE_ROWS * LD;         // [2][KT][LD]
  bf16* Vs = Ks + 2 * KT * LD;            // [2][KT][LD]
  const int tid = threadIdx.x;

  // the tile's q rows by cp.async, all in flight (empty rows zero); each
  // thread pre-scales its own vectors in bf16 once they land
  for (int e = tid; e < TILE_ROWS * VPR; e += THREADS) {
    const int r = e / VPR;
    const int c = (e % VPR) * 8;
    const int row = j.rows[r];
    ptt::cp_async16(Qs + r * LD + c,
                    row >= 0 ? q + static_cast<size_t>(row) * D + c : q,
                    row >= 0 ? 16 : 0);
  }
  ptt::cp_async_commit();

  // K/V tile t (keys k0 + 64t ..) into buffer t & 1; keys past the split
  // are zero-filled, so no stale value meets a zero weight
  const pg::PageOf pof(page);
  auto load_tile = [&](int t) {
    bf16* kd = Ks + (t & 1) * KT * LD;
    bf16* vd = Vs + (t & 1) * KT * LD;
    const int base = j.k0 + t * KT;
    for (int e = tid; e < KT * VPR; e += THREADS) {
      const int rr = e / VPR;
      const int c = (e % VPR) * 8;
      const int key = base + rr;
      if (key < j.k1) {
        const long long off = j.pages[pof.index(key - j.k0)] * s_page +
                              pof.token(key) * s_tok + c;
        ptt::cp_async16(kd + rr * LD + c, kbase + off);
        ptt::cp_async16(vd + rr * LD + c, vbase + off);
      } else {
        ptt::cp_async16(kd + rr * LD + c, kbase, 0);
        ptt::cp_async16(vd + rr * LD + c, vbase, 0);
      }
    }
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int ra = warp * 16 + g;           // the thread's two rows
  const int rb = ra + 8;
  const int kend_a = ra < j.nr ? min(j.kcap, j.ctx + (j.r0 + ra) / j.rep + 1)
                               : 0;
  const int kend_b = rb < j.nr ? min(j.kcap, j.ctx + (j.r0 + rb) / j.rep + 1)
                               : 0;
  const bool live = warp * 16 < j.nr;     // warp-uniform
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const int n_kt = (j.k1 - j.k0 + KT - 1) / KT;
  if (n_kt > 0) load_tile(0);
  ptt::cp_async_commit();
  for (int t = 0; t < n_kt; ++t) {
    if (t + 1 < n_kt) load_tile(t + 1);   // the other buffer is free
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();              // tile t (and Q) has landed
    if (t == 0)
      for (int e = tid; e < TILE_ROWS * VPR; e += THREADS) {
        bf16* x = Qs + (e / VPR) * LD + (e % VPR) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          x[i] = __float2bfloat16(__bfloat162float(x[i]) * scale);
      }
    __syncthreads();                      // and the Q tile is staged
    if (live) {
      const bf16* Kb = Ks + (t & 1) * KT * LD;
      const bf16* Vb = Vs + (t & 1) * KT * LD;
      float s[KT / 8][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      ptt::attn::mma_rows_nk<KT / 8, D / 16>(s, Qs, LD, warp * 16, Kb, LD,
                                             0);
      const int base = j.k0 + t * KT;
      float mx_a = -INFINITY, mx_b = -INFINITY;
      // scores in the log2 domain: every exponential is one exp2
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = base + n * 8 + 2 * t4 + (e & 1);
          s[n][e] = key < (e < 2 ? kend_a : kend_b) ? s[n][e] * pg::LOG2E
                                                    : -INFINITY;
          if (e < 2)
            mx_a = fmaxf(mx_a, s[n][e]);
          else
            mx_b = fmaxf(mx_b, s[n][e]);
        }
      mx_a = ptt::attn::quad_max(mx_a);
      mx_b = ptt::attn::quad_max(mx_b);
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      // a row with no key yet subtracts 0: its scores are -inf, p = 0
      const float ua = mn_a == -INFINITY ? 0.f : mn_a;
      const float ub = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - ua);
      const float al_b = exp2f(m_b - ub);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[nd][0] *= al_a;
        o[nd][1] *= al_a;
        o[nd][2] *= al_b;
        o[nd][3] *= al_b;
      }
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - (e < 2 ? ua : ub));
          s[n][e] = p;
          if (e < 2)
            l_a += p;
          else
            l_b += p;
        }
      // O += P V, P as its hi and lo bf16 parts
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        uint32_t ah[4], al[4];
        split_p(ah, al, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b0[2], b1[2];
          ptt::attn::ld_b_kn(b0, b1, Vb, LD, np * 16, kk * 16);
          ptt::mma_bf16_16816(o[2 * np], ah, b0);
          ptt::mma_bf16_16816(o[2 * np], al, b0);
          ptt::mma_bf16_16816(o[2 * np + 1], ah, b1);
          ptt::mma_bf16_16816(o[2 * np + 1], al, b1);
        }
      }
    }
    __syncthreads();                      // buffer t & 1 free again
  }
  ptt::cp_async_wait<0>();
  l_a = ptt::attn::quad_sum(l_a);
  l_b = ptt::attn::quad_sum(l_b);

  const int row_a = ra < j.nr ? j.rows[ra] : -1;
  const int row_b = rb < j.nr ? j.rows[rb] : -1;
  if (j.n_live == 1) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * t4;
      if (row_a >= 0)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_a) * D +
                                     col) =
            ptt::pack_bf16(l_a == 0.f ? 0.f : o[nd][0] / l_a,
                           l_a == 0.f ? 0.f : o[nd][1] / l_a);
      if (row_b >= 0)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row_b) * D +
                                     col) =
            ptt::pack_bf16(l_b == 0.f ? 0.f : o[nd][2] / l_b,
                           l_b == 0.f ? 0.f : o[nd][3] / l_b);
    }
    return;
  }
  const size_t zr = static_cast<size_t>(j.z) * j.R;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t4;
    if (row_a >= 0)
      *reinterpret_cast<float2*>(part_o + (zr + row_a) * D + col) =
          make_float2(o[nd][0], o[nd][1]);
    if (row_b >= 0)
      *reinterpret_cast<float2*>(part_o + (zr + row_b) * D + col) =
          make_float2(o[nd][2], o[nd][3]);
  }
  if (t4 == 0) {
    if (row_a >= 0) part_ml[zr + row_a] = make_float2(m_a, l_a);
    if (row_b >= 0) part_ml[zr + row_b] = make_float2(m_b, l_b);
  }
  if (pg::ticket_last(j.ticket, j.n_live))
    pg::merge_rows<bf16, D, TILE_ROWS, THREADS>(
        j.rows, j.nr, j.n_live, j.R, part_o, part_ml, out,
        reinterpret_cast<float2*>(big), TILE_ROWS);
}

// A walk tile: up to G (<= WALK_ROWS) rows over one split.
template <typename T, int D, int G>
__device__ __forceinline__ void walk_job(
    const Job j, const T* __restrict__ q, const T* __restrict__ kbase,
    const T* __restrict__ vbase, int page, long long s_page, long long s_tok,
    float scale, unsigned char* big, float* part_o, float2* part_ml,
    T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPK = D / VEC;
  constexpr int UNROLL = G <= 2 ? 8 : 4;  // keys in flight per lane group
  const int sl = (threadIdx.x % 32) % LPK;
  float qr[G][VEC];
  int nvis[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < j.nr) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + static_cast<size_t>(j.rows[g]) * D + sl * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qr[g][i] = ptt::to_f(ptt::from_f<T>(ptt::to_f(e[i]) * scale)) *
                   pg::LOG2E;
      nvis[g] = min(j.kcap, j.ctx + (j.r0 + g) / j.rep + 1);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
      nvis[g] = 0;
    }
  }
  float* s_m = reinterpret_cast<float*>(big);   // [WARPS][G]
  float* s_l = s_m + WARPS * G;                 // [WARPS][G]
  float* s_acc = s_l + WARPS * G;               // [WARPS][G][D]
  float* res_m = s_acc + WARPS * G * D;         // [G]
  float* res_l = res_m + G;                     // [G]
  pg::walk_split<T, D, G, WARPS, UNROLL>(
      qr, nvis, j.k0, j.k1, j.pages, page, kbase + sl * VEC,
      vbase + sl * VEC, s_page, s_tok, s_m, s_l, s_acc);
  __syncthreads();
  pg::combine_warps<G, D, WARPS>(s_m, s_l, s_acc, j.nr, res_m, res_l);
  __syncthreads();
  pg::finish_split<T, D, G, THREADS>(
      j.rows, j.nr, res_m, res_l, s_acc, j.z, j.n_live, j.R, part_o, part_ml,
      j.ticket, out, reinterpret_cast<float2*>(big), TILE_ROWS);
}

// part_o / part_ml: the splits' partials, [n_split][T * nh] rows;
// tickets: [tiles][kvh], tiles bounded on the host.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ q_start,
                              const int* __restrict__ q_len,
                              const int* __restrict__ kv_len,
                              const int* __restrict__ page_table,
                              const int* __restrict__ row_tiles,
                              T* __restrict__ out, float* part_o,
                              float2* part_ml, int* tickets, int T_, int nh,
                              int kvh, int page, int B, int ppmax,
                              int sk, long long s_head, long long s_page,
                              long long s_tok, float scale) {
  constexpr bool TC = sizeof(T) == 2;     // bf16: tensor-core tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np_max = sk / page;
  int* s_qs = reinterpret_cast<int*>(smem_raw);
  int* s_ql = s_qs + B;
  int* s_kl = s_ql + B;
  int* s_own = s_kl + B;                  // [B] row-tile flags
  int* s_item0 = s_own + B;               // [B + 1] items before sequence s
  int* s_tile0 = s_item0 + B + 1;         // [B + 1] tiles before sequence s
  int* s_rows = s_tile0 + B + 1;          // [TILE_ROWS]
  int* s_pages = s_rows + TILE_ROWS;      // [np_max]
  unsigned char* big = smem_raw + head_bytes(B, np_max);
  const int rep = nh / kvh;
  const int kcap_table = ppmax * page;

  // the schedule, by warp 0: per sequence its tiles and items (tile x
  // live split), as prefix sums
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int icarry = 0, tcarry = 0;
    for (int base = 0; base < B; base += 32) {
      const int s = base + lane;
      int nt = 0, items = 0;
      if (s < B) {
        const int ql = q_len[s];
        const int kl = kv_len[s];
        const int own = row_tiles != nullptr && row_tiles[s] != 0;
        s_qs[s] = q_start[s];
        s_ql[s] = ql;
        s_kl[s] = kl;
        s_own[s] = own;
        const Tiling tl(TC, own, ql, rep);
        const int ctx = kl - ql;
        const int kcap = min(kl, kcap_table);
        nt = tl.tiles;
        for (int k = 0; k < nt; ++k) {
          int r0, r1;
          tl.rows(k, r0, r1);
          items += pg::live_splits(tile_kend(r1, rep, ctx, kcap), sk);
        }
      }
      int a = nt, c = items;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int ya = __shfl_up_sync(0xffffffffu, a, off);
        const int yc = __shfl_up_sync(0xffffffffu, c, off);
        if (lane >= off) {
          a += ya;
          c += yc;
        }
      }
      if (s < B) {
        s_tile0[s] = tcarry + a - nt;
        s_item0[s] = icarry + c - items;
      }
      tcarry += __shfl_sync(0xffffffffu, a, 31);
      icarry += __shfl_sync(0xffffffffu, c, 31);
    }
    if (lane == 0) {
      s_tile0[B] = tcarry;
      s_item0[B] = icarry;
    }
  }
  __syncthreads();

  // rows no sequence owns are zeros
  for (int t = blockIdx.x; t < T_; t += gridDim.x) {
    bool owned = false;
    for (int s = 0; s < B; ++s)
      owned |= t >= s_qs[s] && t < s_qs[s] + s_ql[s];
    if (!owned) {
      uint4* dst =
          reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * nh * D);
      const int n = nh * D * static_cast<int>(sizeof(T)) / 16;
      for (int i = threadIdx.x; i < n; i += THREADS)
        dst[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int total = s_item0[B] * kvh;
  for (int w = blockIdx.x; w < total; w += gridDim.x) {
    const int kh = w % kvh;
    int item = w / kvh;
    int s = 0;
    while (s_item0[s + 1] <= item) ++s;
    item -= s_item0[s];
    const int ql = s_ql[s];
    const Tiling tl(TC, s_own[s] != 0, ql, rep);
    const int rpt = tl.rpt;
    Job j;
    j.rep = rep;
    j.ctx = s_kl[s] - ql;
    j.kcap = min(s_kl[s], kcap_table);
    int k = 0, r1 = 0;
    for (;; ++k) {
      tl.rows(k, j.r0, r1);
      j.n_live = pg::live_splits(tile_kend(r1, rep, j.ctx, j.kcap), sk);
      if (item < j.n_live) break;
      item -= j.n_live;
    }
    j.z = item;
    j.nr = r1 - j.r0;
    pg::split_range(j.z, sk / page, page,
                    tile_kend(r1, rep, j.ctx, j.kcap), j.k0, j.k1);
    for (int r = threadIdx.x; r < rpt; r += THREADS) {
      const int idx = j.r0 + r;
      s_rows[r] = r < j.nr
                      ? (s_qs[s] + idx / rep) * nh + kh * rep + idx % rep
                      : -1;
    }
    pg::stage_pages(s_pages, page_table + static_cast<size_t>(s) * ppmax,
                    j.k0, j.k1, page);
    j.rows = s_rows;
    j.pages = s_pages;
    j.R = T_ * nh;
    j.ticket = tickets + static_cast<size_t>(s_tile0[s] + k) * kvh + kh;
    __syncthreads();                      // rows and pages are staged
    const T* kb = k_pages + kh * s_head;
    const T* vb = v_pages + kh * s_head;
    if constexpr (TC) {
      if (rpt == TILE_ROWS) {
        tile_job<D>(j, q, kb, vb, page, s_page, s_tok, scale, big,
                    part_o, part_ml, out);
        __syncthreads();                  // shared memory is reused
        continue;
      }
    }
    if (j.nr <= 1)
      walk_job<T, D, 1>(j, q, kb, vb, page, s_page, s_tok, scale, big,
                        part_o, part_ml, out);
    else if (j.nr <= 2)
      walk_job<T, D, 2>(j, q, kb, vb, page, s_page, s_tok, scale, big,
                        part_o, part_ml, out);
    else if (j.nr <= 4)
      walk_job<T, D, 4>(j, q, kb, vb, page, s_page, s_tok, scale, big,
                        part_o, part_ml, out);
    else
      walk_job<T, D, WALK_ROWS>(j, q, kb, vb, page, s_page, s_tok, scale,
                                big, part_o, part_ml, out);
    __syncthreads();                      // shared memory is reused
  }
}

// the blocks of `kern` resident at once on the current device (per SM
// at `smem` bytes, times the SMs), cached for the last query
template <typename K>
int resident_blocks(K kern, size_t smem) {
  static const void* fn_cached = nullptr;
  static int dev_cached = -1, blocks = 0;
  static size_t smem_cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const void* fn = reinterpret_cast<const void*>(kern);
  if (fn != fn_cached || dev != dev_cached || smem != smem_cached) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                      smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    fn_cached = fn;
    dev_cached = dev;
    smem_cached = smem;
    blocks = per_sm * sms;
  }
  return blocks;
}

template <typename T, int D>
int launch_d(const void* q, const void* kp, const void* vp, const int* qs,
             const int* ql, const int* kl, const int* pt, const int* own,
             void* out,
             void* part, int* tickets, int T_, int nh, int kvh, int page,
             int B, int ppmax, int sk, long long s_head, long long s_page,
             long long s_tok, float scale, cudaStream_t stream) {
  constexpr bool TC = sizeof(T) == 2;
  auto kern = ragged_paged_attention_kernel<T, D>;
  const int np_max = sk / page;
  const size_t smem = head_bytes(B, np_max) + job_bytes<T, D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rep = nh / kvh;
  const int S = ppmax * page;
  const int n_split = (S + sk - 1) / sk;
  if (n_split > pg::MAX_SPLITS || (part == nullptr && n_split > 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // tiles: at most one walk tile per sequence of <= WALK_ROWS rows, and
  // ceil(rows / tile) for the rest; with row tiles, at most one more a
  // packed row group (a local row)
  const long long rows = static_cast<long long>(T_) * rep;
  const long long tiles = (TC ? (rows + TILE_ROWS - 1) / TILE_ROWS
                              : (rows + WALK_ROWS - 1) / WALK_ROWS) + B +
                          (own != nullptr ? T_ : 0);
  const int resident = resident_blocks(kern, smem);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long most = tiles * kvh * n_split;
  const int grid = static_cast<int>(most < resident ? most : resident);
  const int R = T_ * nh;
  auto* part_ml = static_cast<float2*>(part);
  float* part_o = part == nullptr
                      ? nullptr
                      : static_cast<float*>(part) +
                            pg::part_o_offset(n_split, R);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), qs, ql, kl, pt, own, static_cast<T*>(out),
      part_o, part_ml, tickets, T_, nh, kvh, page, B, ppmax, sk, s_head,
      s_page, s_tok, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* qs,
           const void* ql, const void* kl, const void* pt, const void* own,
           void* out,
           void* part, void* tickets, int T_, int nh, int kvh, int page,
           int d, int B, int ppmax, int sk, long long s_head,
           long long s_page, long long s_tok, float scale, void* stream) {
  if (T_ <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (kvh <= 0 || nh % kvh != 0 || page <= 0 || KT % page != 0 ||
      ppmax <= 0 || sk <= 0 || sk % KT != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  auto* tk = static_cast<int*>(tickets);
  if (d == 64)
    return launch_d<T, 64>(q, kp, vp, i32(qs), i32(ql), i32(kl), i32(pt),
                           i32(own), out, part, tk, T_, nh, kvh, page, B,
                           ppmax, sk, s_head, s_page, s_tok, scale, st);
  if (d == 128)
    return launch_d<T, 128>(q, kp, vp, i32(qs), i32(ql), i32(kl), i32(pt),
                            i32(own), out, part, tk, T_, nh, kvh, page, B,
                            ppmax, sk, s_head, s_page, s_tok, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ptt_ragged_paged_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* q_start,
    const void* q_len, const void* kv_len, const void* page_table,
    const void* row_tiles, void* out, void* part, void* tickets, int T,
    int nh, int kvh, int page, int d, int B, int ppmax, int sk,
    long long s_head, long long s_page, long long s_tok, float scale,
    void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, q_start, q_len, kv_len, page_table,
                               row_tiles, out, part, tickets, T, nh, kvh,
                               page, d, B, ppmax, sk, s_head, s_page, s_tok,
                               scale, stream);
}

extern "C" int ptt_ragged_paged_attention_f32(
    const void* q, const void* kp, const void* vp, const void* q_start,
    const void* q_len, const void* kv_len, const void* page_table,
    const void* row_tiles, void* out, void* part, void* tickets, int T,
    int nh, int kvh, int page, int d, int B, int ppmax, int sk,
    long long s_head, long long s_page, long long s_tok, float scale,
    void* stream) {
  return launch<float>(q, kp, vp, q_start, q_len, kv_len, page_table,
                       row_tiles, out, part, tickets, T, nh, kvh, page, d, B,
                       ppmax, sk, s_head, s_page, s_tok, scale, stream);
}
