// Flash attention on a TMA + mbarrier + wgmma core (sm_90a): the bf16
// one-length route, BSHD in and out, causal or full, MHA and GQA (q head
// h reads kv head h / (Hq / Hk)), head dim 64 or 128, q and kv of one
// length S, no segment ids, no bias: every call of the entries
// `ptt_flash_attention_fwd_bf16` and `ptt_flash_attention_bwd_bf16`.
// The segment, bias and f32 routes stay on flash_attention.cu's kernels.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::flash_attention_bshd
//   -> upstream jax/experimental/pallas/ops/tpu/flash_attention.py (fwd
//   pallas_call l.758, bwd dkv l.1121, bwd dq l.1456) for MHA and the
//   splash MQA kernel (`_splash_gqa`) for GQA; the delta pre-pass is the
//   jnp rowsum(dO * O) of upstream's backward (l.1664).
// Bound on the H100: operations. At llama_7b's training shape [4, 2048,
//   32, 128] causal the forward does 4 B H D S(S+1)/2 = 137.5 GFLOP
//   against 134 MB (0.139 ms at 989 TFLOP/s), the backward 2.5 times
//   that in the five products it needs (it runs seven: dkv and dq each
//   recompute S and dP). The delta pre-pass is bound by bytes (it reads
//   O and dO once: 134 MB, 0.04 ms).
// Design (FlashAttention-3's shape, without its ping-pong between
//   consumers): one block of three warpgroups owns one tile. Warpgroup 0
//   is the producer (registers cut by setmaxnreg): one thread issues
//   TMA loads of whole tiles of one head through a 4D tensor map over
//   BSHD (hopper.cuh, tma_map_bshd; a tile of D = 128 is two boxes of 64
//   columns, each [rows][64] in 128-byte swizzle atoms) into a
//   three-stage ring whose stages carry full and empty mbarriers.
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
//     (128 rows a stage); it writes O and the f32 log-sum-exp [B, Hq, S]
//     (rows < S only).
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
//   P and dS are rounded to bf16 before their products, as the mma.sync
//   kernels and every flash kernel do; `scale` multiplies the f32 scores
//   (MHA); GQA callers pass q pre-scaled in q's dtype and scale = 1.

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

// rows [r0, r0 + ROWS) of head h of batch b: NB boxes of [ROWS][64]
// (the map's box is ROWS rows), completing on bar
template <int NB, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int b, int h,
                                          int r0) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    hw::tma_load_4d(dst + nb * ROWS * 64, map, bar, nb * 64, h, r0, b);
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

template <int D>
using FwdGeo = Geo<D, 128, 128>;

template <int D>
constexpr int fwd_smem() {
  using G = FwdGeo<D>;
  return G::M_BYTES + G::STAGES * 2 * G::N_BYTES + 1024 + 8 * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ o, float* __restrict__ lse, int S,
                       int Hq, int Hk, int causal, float scale) {
  using G = FwdGeo<D>;
  constexpr int BM = G::BM, BN = G::BN, STAGES = G::STAGES;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  unsigned char* smem = align1024(fa_smem);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + G::M_BYTES;     // stage s: K, then V
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(ring + STAGES * 2 * G::N_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);           // one arrival per consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hw::mbar_arrive_expect_tx(q_full, G::M_BYTES);
      load_tile<G::NB, BM>(Qs, &map_q, q_full, b, h, q0);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        hw::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        bf16* Ks = reinterpret_cast<bf16*>(ring + s * 2 * G::N_BYTES);
        hw::mbar_arrive_expect_tx(&full[s], 2 * G::N_BYTES);
        load_tile<G::NB, BN>(Ks, &map_k, &full[s], b, hk, j * BN);
        load_tile<G::NB, BN>(Ks + BN * D, &map_v, &full[s], b, hk, j * BN);
      }
    }
  } else {
    hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int row_lo = q0 + cw * 64;           // this consumer's 64 rows
    const int r0 = row_lo + (t >> 5) * 16 + (lane >> 2);  // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;

    // software-pipelined: tile j's S = Q K^T is issued together with
    // tile j - 1's O += P V, and its softmax runs while the latter is in
    // flight; O is rescaled once that product has retired
    float acc[D / 2];                          // O [64 x D]
    float sc[BN / 2];                          // S [64 x BN], then P
    uint32_t pf[BN / 16][4];                   // P of the previous tile
    float m2[2] = {-INFINITY, -INFINITY};      // row max, log2 units
    float l[2] = {0.f, 0.f};                   // this thread's row sums
    hw::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const int sp = (j + STAGES - 1) % STAGES;  // the previous tile's
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
      const bf16* Ks = reinterpret_cast<const bf16*>(ring + s * 2 * G::N_BYTES);
      const int k0 = j * BN;

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
                             ring + sp * 2 * G::N_BYTES) + BN * D;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hw::wgmma_rs<1>(acc, pf[kk], mnmajor<BN>(Vp, kk), j > 1 || kk > 0);
        hw::wgmma_commit();
        hw::wgmma_wait<1>();
      } else {
        hw::wgmma_wait<0>();
      }
      hw::fence_regs(sc);

      // scores in log2 units; -inf past S and above the diagonal
      const bool edge = (causal && k0 + BN > row_lo) || k0 + BN > S;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int hh = (i >> 1) & 1;
        float x = sc[i] * sl2;
        if (edge) {
          const int col = k0 + 8 * (i >> 2) + c_off + (i & 1);
          if (col >= S || (causal && col > r0 + 8 * hh)) x = -INFINITY;
        }
        sc[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m2[r], quad_max(mx[r]));
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2(m2[r] - m_use[r]);
        m2[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = ex2(sc[i] - m_use[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
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
      // the last tile's P V (n_kv >= 1: q0 < S)
      const int sl = (n_kv - 1) % STAGES;
      const bf16* Vl =
          reinterpret_cast<const bf16*>(ring + sl * 2 * G::N_BYTES) + BN * D;
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hw::wgmma_rs<1>(acc, pf[kk], mnmajor<BN>(Vl, kk), n_kv > 1 || kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float lsum = quad_sum(l[hh]);
      const int row = r0 + 8 * hh;
      if (row >= S) continue;
      const float inv = 1.f / lsum;
      bf16* dst = o + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = ptt::pack_bf16(
            acc[4 * jj + 2 * hh] * inv, acc[4 * jj + 2 * hh + 1] * inv);
      if ((lane & 3) == 0)
        lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
            m2[hh] * kLn2 + logf(lsum);
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

// ------------------------------ backward: dkv ------------------------------

template <int D>
using DkvGeo = Geo<D, 128, 64>;              // 128 kv rows; q tiles of 64

template <int D>
constexpr int dkv_smem() {
  using G = DkvGeo<D>;
  // K, V; per stage Q, dO; per stage the q tile's LSE (log2 units) and D
  return 2 * G::M_BYTES + G::STAGES * 2 * G::N_BYTES +
         G::STAGES * 2 * G::BN * 4 + 1024 + 8 * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int S, int Hq, int Hk, int causal, float scale) {
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

  const int k0 = blockIdx.x * BM;              // early keys see the most q
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hk;
  const int q_begin = causal ? k0 : 0;         // k0 is a multiple of BN
  const int n_q = q_begin < S ? (S - q_begin + BN - 1) / BN : 0;
  const int total = group * n_q;

  if (threadIdx.x == 0) {
    hw::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 32);           // the producer warp's lanes
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        hw::mbar_arrive_expect_tx(kv_full, 2 * G::M_BYTES);
        load_tile<G::NB, BM>(Ks, &map_k, kv_full, b, hk, k0);
        load_tile<G::NB, BM>(Vs, &map_v, kv_full, b, hk, k0);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        const int h = hk * group + it / n_q;
        const int q0 = q_begin + (it % n_q) * BN;
        hw::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        float* ls = lsd + s * 2 * BN;
#pragma unroll
        for (int r = lane; r < BN; r += 32) {
          const int row = q0 + r;
          const size_t i = (static_cast<size_t>(b) * Hq + h) * S + row;
          ls[r] = row < S ? lse[i] * kLog2e : INFINITY;
          ls[BN + r] = row < S ? delta[i] : 0.f;
        }
        if (lane == 0) {
          hw::mbar_arrive_expect_tx(&full[s], 2 * G::N_BYTES);
          bf16* Qs = reinterpret_cast<bf16*>(ring + s * 2 * G::N_BYTES);
          load_tile<G::NB, BN>(Qs, &map_q, &full[s], b, h, q0);
          load_tile<G::NB, BN>(Qs + BN * D, &map_do, &full[s], b, h, q0);
        } else {
          hw::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    hw::setmaxnreg_inc<240>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const int kv_lo = k0 + cw * 64;            // this consumer's 64 kv rows
    const int r0 = kv_lo + (t >> 5) * 16 + (lane >> 2);   // + 8 hh
    const int c_off = 2 * (lane & 3);
    const float sl2 = scale * kLog2e;

    float adk[D / 2], adv[D / 2];              // dK, dV [64 x D]
    bool started = false;
    hw::mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % STAGES;
      const int q0 = q_begin + (it % n_q) * BN;
      hw::mbar_wait(&full[s], (it / STAGES) & 1);
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

        const bool edge = (causal && q0 < kv_lo + 64) || q0 + BN > S ||
                          kv_lo + 64 > S;
        uint32_t pf[BN / 16][4], dsf[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int i = 8 * kk + 2 * x;
            const int kj = r0 + 8 * (x & 1);
            float p[2], ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * (i >> 2) + c_off + e;   // q column
              p[e] = ex2(fmaf(st[i + e], sl2, -ls[c]));
              if (edge) {
                const int qi = q0 + c;
                if (qi >= S || kj >= S || (causal && kj > qi)) p[e] = 0.f;
              }
              ds[e] = p[e] * (dpt[i + e] - ls[BN + c]);
            }
            pf[kk][x] = ptt::pack_bf16(p[0], p[1]);     // P^T
            dsf[kk][x] = ptt::pack_bf16(ds[0], ds[1]);  // dS^T
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

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= S) continue;
      const size_t base =
          ((static_cast<size_t>(b) * S + row) * Hk + hk) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int i = 4 * jj + 2 * hh;
        *reinterpret_cast<uint32_t*>(dk + base + 8 * jj) =
            ptt::pack_bf16(adk[i] * scale, adk[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + base + 8 * jj) =
            ptt::pack_bf16(adv[i], adv[i + 1]);
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
  return 2 * G::M_BYTES + G::STAGES * 2 * G::N_BYTES + 1024 + 8 * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int S, int Hq, int Hk,
                          int causal, float scale) {
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

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BM;
  const int kv_end = causal ? min(S, q0 + BM) : S;
  const int n_kv = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hw::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 8);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 0) {
    hw::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hw::mbar_arrive_expect_tx(q_full, 2 * G::M_BYTES);
      load_tile<G::NB, BM>(Qs, &map_q, q_full, b, h, q0);
      load_tile<G::NB, BM>(dOs, &map_do, q_full, b, h, q0);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        hw::mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        bf16* Ks = reinterpret_cast<bf16*>(ring + s * 2 * G::N_BYTES);
        hw::mbar_arrive_expect_tx(&full[s], 2 * G::N_BYTES);
        load_tile<G::NB, BN>(Ks, &map_k, &full[s], b, hk, j * BN);
        load_tile<G::NB, BN>(Ks + BN * D, &map_v, &full[s], b, hk, j * BN);
      }
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
    // this thread's two rows: LSE in log2 units (+inf past S: P = 0), D
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      const size_t i = (static_cast<size_t>(b) * Hq + h) * S + row;
      lse2[hh] = row < S ? lse[i] * kLog2e : INFINITY;
      dl[hh] = row < S ? delta[i] : 0.f;
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
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % STAGES;
      const int sp = (j + STAGES - 1) % STAGES;  // the previous tile's
      const int k0 = j * BN;
      hw::mbar_wait(&full[s], (j / STAGES) & 1);
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
      const bool edge = (causal && k0 + BN > row_lo) || k0 + BN > S;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int hh = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], sl2, -lse2[hh]));
        if (edge) {
          const int kj = k0 + 8 * (i >> 2) + c_off + (i & 1);
          if (kj >= S || (causal && kj > r0 + 8 * hh)) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[hh]);          // dS
      }
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
      // the last tile's dQ += dS K (n_kv >= 1: q0 < S)
      const int sl = (n_kv - 1) % STAGES;
      const bf16* Kl =
          reinterpret_cast<const bf16*>(ring + sl * 2 * G::N_BYTES);
      hw::fence_regs(acc);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hw::wgmma_rs<1>(acc, dsf[kk], mnmajor<BN>(Kl, kk), n_kv > 1 || kk > 0);
      hw::wgmma_commit();
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 8 * hh;
      if (row >= S) continue;
      bf16* dst =
          dq + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + c_off;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) = ptt::pack_bf16(
            acc[4 * jj + 2 * hh] * scale, acc[4 * jj + 2 * hh + 1] * scale);
    }
  }
}

// -------------------------------- launch -----------------------------------

struct Shape {
  int B, S, Hq, Hk, D, causal;
  float scale;
};

// 0 = launch, -1 = nothing to do, else the error to return
int check_shape(const Shape& s) {
  if (s.B <= 0 || s.S <= 0) return -1;
  if (s.Hk <= 0 || s.Hq % s.Hk != 0 || (s.D != 64 && s.D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <class K>
cudaError_t prepare(K kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the maps of q, k, v (and dout) with the box rows each kernel streams
struct Maps {
  CUtensorMap q, k, v, dout;
};

int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, const Shape& s, int q_rows, int kv_rows) {
  int err = hw::tma_map_bshd(&m->q, q, s.B, s.S, s.Hq, s.D, q_rows);
  if (err == 0) err = hw::tma_map_bshd(&m->k, k, s.B, s.S, s.Hk, s.D, kv_rows);
  if (err == 0) err = hw::tma_map_bshd(&m->v, v, s.B, s.S, s.Hk, s.D, kv_rows);
  if (err == 0 && dout != nullptr)
    err = hw::tma_map_bshd(&m->dout, dout, s.B, s.S, s.Hq, s.D, q_rows);
  return err;
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const Shape& s, cudaStream_t stream) {
  using G = FwdGeo<D>;
  Maps m;
  int err = make_maps(&m, q, k, v, nullptr, s, G::BM, G::BN);
  if (err != 0) return err;
  constexpr int smem = fwd_smem<D>();
  cudaError_t e = prepare(flash_fwd_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((s.S + G::BM - 1) / G::BM, s.Hq, s.B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, static_cast<bf16*>(o), static_cast<float*>(lse), s.S,
      s.Hq, s.Hk, s.causal, s.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq_out, void* dk,
        void* dv, const Shape& s, cudaStream_t stream) {
  {
    using G = DkvGeo<D>;
    // the q tiles stream (box BN rows), the kv tile stays (box BM rows)
    Maps m;
    int err = make_maps(&m, q, k, v, dout, s, G::BN, G::BM);
    if (err != 0) return err;
    constexpr int smem = dkv_smem<D>();
    cudaError_t e = prepare(flash_bwd_dkv_wgmma_kernel<D>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((s.S + G::BM - 1) / G::BM, s.Hk, s.B);
    flash_bwd_dkv_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
        m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s.S, s.Hq, s.Hk, s.causal, s.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  using G = DqGeo<D>;
  Maps m;
  int err = make_maps(&m, q, k, v, dout, s, G::BM, G::BN);
  if (err != 0) return err;
  constexpr int smem = dq_smem<D>();
  cudaError_t e = prepare(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((s.S + G::BM - 1) / G::BM, s.Hq, s.B);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dq_out), s.S,
      s.Hq, s.Hk, s.causal, s.scale);
  return static_cast<int>(cudaGetLastError());
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

// ---- the one-length bf16 route (the training slice): the wgmma core ----

extern "C" int ptt_flash_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int S, int Hq, int Hk,
                                            int D, int causal, float scale,
                                            void* stream) {
  const Shape s{B, S, Hq, Hk, D, causal, scale};
  const int c = check_shape(s);
  if (c != 0) return c < 0 ? 0 : c;
  auto st = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd<64>(q, k, v, o, lse, s, st)
                 : fwd<128>(q, k, v, o, lse, s, st);
}

// delta [B, H, S] f32 from the BSHD output and its cotangent, then dkv,
// then dq
extern "C" int ptt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int S, int Hq, int Hk, int D, int causal, float scale, void* stream) {
  const Shape s{B, S, Hq, Hk, D, causal, scale};
  const int c = check_shape(s);
  if (c != 0) return c < 0 ? 0 : c;
  auto st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  return D == 64 ? bwd<64>(q, k, v, dout, l, d, dq, dk, dv, s, st)
                 : bwd<128>(q, k, v, dout, l, d, dq, dk, dv, s, st);
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
