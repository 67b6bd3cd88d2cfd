// SwiGLU forward and backward, where w_gate_up = [Wg | Wu] is [H, 2M]
// (gate columns first) and a is [T, H].
//
// Forward: out[T, M] = silu(a @ Wg) * (a @ Wu). The [T, 2M] gate/up
//   product is never stored: each block computes the g and u tiles of its
//   output tile in f32 and applies silu(g) * u in the epilogue.
// Backward, two C entries:
//   `bwd_da` recomputes each g/u tile with the forward's main loop, turns
//     the output cotangent into the gate/up cotangents in f32 (dg = do *
//     u * silu'(g), du = do * silu(g), the reference's float order) and
//     writes them once, rounded to the input dtype, as dgu = [dg | du]
//     [T, 2M]; then da[T, H] = dgu @ w_gate_up^T, accumulated over the 2M
//     columns in f32 and written once.
//   `bwd_dw` computes dw[H, 2M] = [dWg | dWu] = a^T @ dgu, accumulated
//     over the T rows in f32 (one block per output tile with a long K
//     loop over T) and written once.
//
// Replaces: paddle_tpu/kernels/swiglu.py::swiglu (_fwd_impl ->
//   _fwd_kernel, the blockwise Pallas GEMM with the fused epilogue) and
//   its backward _bwd_impl -> _bwd_da_kernel and _bwd_dw_kernel.
// Bound on the H100: at the training shapes (T = 8192 rows) every product
//   is bound by operations: 2*T*H*2M = 1.477 TFLOP each for the forward,
//   the recompute, da and dw at llama_7b's H = 4096, M = 11008 (1.49 ms
//   at 989 TFLOP/s) against 64-360 MB of operands (0.02-0.11 ms at 3.35
//   TB/s). The forward at serving T (4-128 rows) is bound by bytes: the
//   180 MB weight read per layer against 23 GFLOP at T = 128.
// Design, bf16 (two cores, one routing test, see mma_launch):
//   wgmma_swiglu_kernel, sm_90a: whenever the shape allows TMA (every row
//     length % 8 == 0, 16-byte aligned bases: `vec_ok`). A block owns a
//     128 x 256 tile of op(A) @ op(B) and walks K in steps of 64 through
//     a 4-stage ring of 128-byte-swizzled shared-memory tiles (48 KB a
//     stage, 192 KB in all, one block per SM). Warp-specialised: one
//     producer warpgroup (registers cut by setmaxnreg) in which one thread
//     starts each stage's TMA loads against a full-barrier; two consumer
//     warpgroups each run wgmma m64n256k16 over their 64 rows (128 f32
//     accumulators a thread) and release a stage on its empty-barrier
//     once their products on it have retired (wgmma.wait_group 1). The
//     operands' majors are the transpose bits: the gate/up products read
//     a K-major and w [H, 2M] N-major; da reads dgu K-major and w as B^T,
//     K-major; dw reads a^T M-major and dgu N-major. With GU the B stage
//     holds gate columns [n0, n0 + 128) and up columns [M + n0, M + n0 +
//     128) as four 64-column boxes, so column c and c + 128 of a row sit
//     in one thread and the epilogues take g and u from registers; a
//     block writes a 128 x 128 output tile. TMA zero-fills the ragged T,
//     N and K edges (K = 2M = 1376 works), the epilogue masks rows and
//     columns, and stores go from registers as bf16 pairs. The grid is
//     persistent (one block per SM walking the tiles in groups of 16 row
//     tiles, so the blocks in flight share their A and B tiles in L2):
//     the producer fills the ring for the next tile while the consumers
//     run this one's epilogue, and the recompute's epilogue reads its do
//     pairs into registers when the tile starts, behind the main loop.
//   mma_kernel: mma.sync m16n8k16 fed by ldmatrix from a 3-slot cp.async
//     ring (128 x 128 tiles, K step 64, 8 warps of 64 x 32). It takes the
//     shapes TMA cannot (vec_ok == 0: unaligned or odd widths, any H and
//     M, with masked scalar loads), and the forward at T <= SMALL_T rows,
//     where the 128-row tile of the wgmma core would leave most of the
//     card idle on a bytes-bound weight read (M / 128 = 86 blocks at
//     llama_7b for 132 SMs); there its 64-column tiles give 172 blocks.
//   The f32 variant (the CPU-parity dtype) is a register-tiled SIMT GEMM
//   with the same epilogues: the tensor cores have no full-precision f32
//   product.
//   The TPU kernels keep da's [rows, H] and dw's [H, cols] f32
//   accumulators in VMEM (megabytes) while they recompute g/u; an SM's
//   227 KB cannot hold them, and recomputing g/u once per H tile would
//   multiply the recompute GEMM by H / tile. So the recomputed cotangents
//   are written once (bf16: 360 MB at the 7B shape, 0.1 ms of
//   device-memory traffic against ~1.5 ms of products) and da and dw read
//   them; the values are those of the fused design, which rounds dg/du
//   to bf16 for its tensor-core products all the same.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// Gate/up cotangents of one element, the reference's _dgu_tile order:
// s = sigmoid(g); dg = do * u * (s + g * s * (1 - s)); du = do * (g * s).
__device__ __forceinline__ void dgu_of(float g, float u, float d, float* dg,
                                       float* du) {
  const float s = 1.f / (1.f + expf(-g));
  *dg = d * u * (s + g * s * (1.f - s));
  *du = d * (g * s);
}

// two f32 -> two adjacent bf16 in one 4-byte store (p 4-byte aligned)
__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// Epilogues of the gate/up main loop, called once per in-range element
// (row r, column c < M) with the f32 g and u. The wgmma core calls `pair`
// for columns c and c + 1 (c even, M even; bf16 only) with what `fetch`
// read for them when the tile began, so the epilogue's loads wait behind
// the main loop rather than after it.
template <typename T>
struct FwdEpi {
  T* out;
  int M;
  __device__ void operator()(int r, int c, float g, float u) const {
    out[static_cast<size_t>(r) * M + c] = ptt::from_f<T>(silu_mul(g, u));
  }
  __device__ uint32_t fetch(int, int) const { return 0; }
  __device__ void pair(int r, int c, float g0, float u0, float g1, float u1,
                       uint32_t) const {
    store_bf16x2(out + static_cast<size_t>(r) * M + c, silu_mul(g0, u0),
                 silu_mul(g1, u1));
  }
};

template <typename T>
struct DguEpi {
  const T* dout;      // [T, M]
  T* dgu;             // [T, 2M]
  int M;
  __device__ void operator()(int r, int c, float g, float u) const {
    float dg, du;
    dgu_of(g, u, ptt::to_f(dout[static_cast<size_t>(r) * M + c]), &dg, &du);
    const size_t row = static_cast<size_t>(r) * 2 * M;
    dgu[row + c] = ptt::from_f<T>(dg);
    dgu[row + M + c] = ptt::from_f<T>(du);
  }
  // do[r, c .. c + 1] as one bf16 pair
  __device__ uint32_t fetch(int r, int c) const {
    return *reinterpret_cast<const uint32_t*>(dout +
                                              static_cast<size_t>(r) * M + c);
  }
  __device__ void pair(int r, int c, float g0, float u0, float g1, float u1,
                       uint32_t dpair) const {
    const float2 d =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dpair));
    float dg0, du0, dg1, du1;
    dgu_of(g0, u0, d.x, &dg0, &du0);
    dgu_of(g1, u1, d.y, &dg1, &du1);
    bf16* row = dgu + static_cast<size_t>(r) * 2 * M;
    store_bf16x2(row + c, dg0, dg1);
    store_bf16x2(row + M + c, du0, du1);
  }
};

// ---------------- bf16: mma.sync tensor-core tiles ------------------------
//
// Every bf16 product whose rows TMA cannot take, and the forward at up to
// SMALL_T rows (file note): a block owns a 128 x 128 tile
// of op(A) @ op(B) and walks K in steps of 64 through a 3-slot cp.async
// ring (two K steps in flight while the tensor cores work on a third; 64
// rather than 32 halves the barriers per product, and 110 KB of ring
// still fits two blocks per SM).
// Its 8 warps (2 x 4) each own 64 x 32 of the tile: per 16-deep slice, 4
// A and 2 B ldmatrix.x4 loads feed 16 mma.sync m16n8k16 products into 64
// f32 accumulators per thread, and the epilogue reads them straight from
// registers. op(A) [Mo, K] is A stored [Mo][K], or with TA stored [K][Mo];
// op(B) [K, No] is B stored [K][No], or with TB stored [No][K]; ldmatrix
// .trans serves the transposed layouts. With GU, B is w_gate_up [K, 2M]
// and the block's 128 columns are 64 gate columns and the same 64 up
// columns, so each thread holds g and u of the same output elements.

constexpr int TM = 128, TN = 128, TK = 64;
constexpr int NSTAGE = 3;
constexpr int LDK = TK + 8;          // k-contiguous tiles [128][72]
constexpr int LDN = TN + 8;          // m/n-contiguous tiles [64][136]
constexpr int TILE = TM * LDK > TK * LDN ? TM * LDK : TK * LDN;
constexpr int MMA_SMEM_BYTES = NSTAGE * 2 * TILE * 2;

// Copy rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major [nr, nc]
// matrix (leading dim ld) into dst[R][ldd]; out-of-range elements are
// zero. vec_ok (nc % 8 == 0, ld % 8 == 0, 16-byte aligned base): 16-byte
// cp.async copies (all 8 columns of a vector are in range or none);
// else masked scalar loads through registers.
template <int R, int C>
__device__ __forceinline__ void load_tile(bf16* dst, int ldd,
                                          const bf16* __restrict__ src,
                                          int r0, int c0, int nr, int nc,
                                          size_t ld, int vec_ok) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int v = threadIdx.x; v < R * C / 8; v += blockDim.x) {
    const int r = v / (C / 8);
    const int c = (v % (C / 8)) * 8;
    const int gr = r0 + r;
    const int gc = c0 + c;
    bf16* d = dst + r * ldd + c;
    if (vec_ok) {
      const bool in = gr < nr && gc < nc;
      ptt::cp_async16(d, in ? src + gr * ld + gc : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < nr && gc + j < nc) ? src[gr * ld + gc + j] : zero;
    }
  }
}

template <bool TA, bool TB, bool GU>
__device__ __forceinline__ void mma_stage(bf16* As, bf16* Bs,
                                          const bf16* __restrict__ A,
                                          const bf16* __restrict__ B,
                                          int m0, int n0, int k0, int Mo,
                                          int No, int K, int vec_ok) {
  if (TA)
    load_tile<TK, TM>(As, LDN, A, k0, m0, K, Mo, Mo, vec_ok);
  else
    load_tile<TM, TK>(As, LDK, A, m0, k0, Mo, K, K, vec_ok);
  if (GU) {                          // B = w_gate_up [K, 2 No]
    const size_t ldw = 2 * static_cast<size_t>(No);
    load_tile<TK, TN / 2>(Bs, LDN, B, k0, n0, K, No, ldw, vec_ok);
    load_tile<TK, TN / 2>(Bs + TN / 2, LDN, B + No, k0, n0, K, No, ldw,
                          vec_ok);
  } else if (TB) {
    load_tile<TN, TK>(Bs, LDK, B, n0, k0, No, K, K, vec_ok);
  } else {
    load_tile<TK, TN>(Bs, LDN, B, k0, n0, K, No, No, vec_ok);
  }
}

// Epilogues of the generic product: called once per in-range element.
struct StoreEpi {
  bf16* C;
  int No;
  __device__ void operator()(int r, int c, float v) const {
    C[static_cast<size_t>(r) * No + c] = __float2bfloat16(v);
  }
  __device__ void pair(int r, int c, float v0, float v1) const {
    store_bf16x2(C + static_cast<size_t>(r) * No + c, v0, v1);
  }
};

template <bool TA, bool TB, bool GU, class Epi>
__global__ void __launch_bounds__(256)
mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int Mo,
           int No, int K, int vec_ok, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * (GU ? TN / 2 : TN);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;
  const int wn = warp & 3;
  const int li = lane >> 3;          // which 8x8 matrix this lane addresses
  const int lr = lane & 7;           // ... and which of its rows

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (K + TK - 1) / TK;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < KT)
      mma_stage<TA, TB, GU>(smem + st * 2 * TILE, smem + st * 2 * TILE + TILE,
                            A, B, m0, n0, st * TK, Mo, No, K, vec_ok);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<NSTAGE - 2>();        // step kt has landed
    __syncthreads();                         // ... for every thread, and
                                             // step kt-1's slot is free
    const int nk = kt + NSTAGE - 1;
    if (nk < KT) {
      bf16* s = smem + (nk % NSTAGE) * 2 * TILE;
      mma_stage<TA, TB, GU>(s, s + TILE, A, B, m0, n0, nk * TK, Mo, No, K,
                            vec_ok);
    }
    ptt::cp_async_commit();

    const bf16* As = smem + (kt % NSTAGE) * 2 * TILE;
    const bf16* Bs = As + TILE;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm + mi * 16;
        if (TA)   // As[k][m]: matrices (m, k) = (0,0) (8,0) (0,8) (8,8)
          ptt::ldmatrix_x4_trans(
              af[mi], As + (kk + lr + (li >> 1) * 8) * LDN + m + (li & 1) * 8);
        else      // As[m][k]: lanes 0-15 rows m.., lanes 16-31 at k + 8
          ptt::ldmatrix_x4(af[mi],
                           As + (m + (lane & 15)) * LDK + kk + (lane >> 4) * 8);
      }
      uint32_t bfr[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // two n8 tiles: matrices (k, n) = (0,0) (8,0) (0,8) (8,8)
        const int nb = GU ? p * (TN / 2) + wn * 16 : wn * 32 + p * 16;
        uint32_t r[4];
        if (TB)   // Bs[n][k]
          ptt::ldmatrix_x4(r, Bs + (nb + lr + (li >> 1) * 8) * LDK + kk +
                                  (li & 1) * 8);
        else      // Bs[k][n]
          ptt::ldmatrix_x4_trans(
              r, Bs + (kk + lr + (li & 1) * 8) * LDN + nb + (li >> 1) * 8);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          ptt::mma_bf16_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  ptt::cp_async_wait<0>();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + mi * 16 + g + h * 8;
      if (r >= Mo) continue;
      if constexpr (GU) {
        // n tiles 0, 1 are gate columns, 2, 3 the same up columns
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wn * 16 + ni * 8 + t2 + e;
            if (c < No)
              epi(r, c, acc[mi][ni][h * 2 + e], acc[mi][ni + 2][h * 2 + e]);
          }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wn * 32 + ni * 8 + t2 + e;
            if (c < No) epi(r, c, acc[mi][ni][h * 2 + e]);
          }
      }
    }
}

// ---------------- bf16: wgmma + TMA, warp-specialised (sm_90a) -----------
//
// op(A) [Mo, K] is A stored [Mo][K] (K-major), or with TA stored [K][Mo]
// (M-major); op(B) [K, No] is B stored [K][No] (N-major), or with TB
// stored [No][K] (K-major); with GU, B is w_gate_up [K][2 No]. Shared
// memory per stage: A as one [128][64] box (TA: two [64 k][64 m] boxes,
// one per consumer), B as one [256][64] box (TB) or four [64 k][64 n]
// boxes, each 1024-byte aligned.

namespace wg {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4, GROUP_M = 16;
constexpr int THREADS = 384;                 // producer + 2 consumers
constexpr int A_BYTES = BM * BK * 2;         // 16 KB
constexpr int B_BYTES = BN * BK * 2;         // 32 KB
constexpr int BOX = 64 * 64;                 // elements of a 64 x 64 box
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the ring, then 2 * STAGES barriers, plus slack to align the ring
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
}  // namespace wg

// (row, column) origin of tile `tile` in the grouped order: GROUP_M row
// tiles walk the column tiles together, so the blocks in flight share
// their A and B tiles in L2
__device__ __forceinline__ void tile_origin(int tile, int Mo, int No,
                                            int n_step, int* m0, int* n0) {
  using namespace wg;
  const int m_tiles = (Mo + BM - 1) / BM;
  const int n_tiles = (No + n_step - 1) / n_step;
  const int per_group = GROUP_M * n_tiles;
  const int first_m = (tile / per_group) * GROUP_M;
  const int gm = min(m_tiles - first_m, GROUP_M);
  const int in_group = tile % per_group;
  *m0 = (first_m + in_group % gm) * BM;
  *n0 = (in_group / gm) * n_step;
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; the ring's stage
// and phase run on across tiles, so the producer loads the next tile
// while the consumers run this one's epilogue.
template <bool TA, bool TB, bool GU, class Epi>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgmma_swiglu_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b, int Mo,
                    int No, int K, Epi epi) {
  namespace hw = ptt::hopper;
  using namespace wg;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* smem =
      wg_smem + ((1024 - (hw::smem_u32(wg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_step = GU ? BN / 2 : BN;
  const int tiles = ((Mo + BM - 1) / BM) * ((No + n_step - 1) / n_step);
  const int KT = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
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
    // producer: one thread keeps the ring full
    hw::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;                            // k steps loaded so far
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, Mo, No, n_step, &m0, &n0);
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          hw::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          bf16* As = reinterpret_cast<bf16*>(smem + s * STAGE_BYTES);
          bf16* Bs =
              reinterpret_cast<bf16*>(smem + s * STAGE_BYTES + A_BYTES);
          const int k0 = kt * BK;
          hw::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          if (TA) {
            hw::tma_load_2d(As, &map_a, &full[s], m0, k0);
            hw::tma_load_2d(As + BOX, &map_a, &full[s], m0 + 64, k0);
          } else {
            hw::tma_load_2d(As, &map_a, &full[s], k0, m0);
          }
          if (TB) {
            hw::tma_load_2d(Bs, &map_b, &full[s], k0, n0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              // GU: gate columns n0.. and the same up columns at No + n0..
              const int c = GU ? (j < 2 ? n0 + 64 * j
                                        : No + n0 + 64 * (j - 2))
                               : n0 + 64 * j;
              hw::tma_load_2d(Bs + j * BOX, &map_b, &full[s], c, k0);
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows [m0 + 64 cw, m0 + 64 cw + 64)
    hw::setmaxnreg_inc<232>();
    const int cw = wgi - 1;
    const int t = threadIdx.x % 128;
    const int lane = t & 31;
    const bool even = (No & 1) == 0;
    int it = 0;                              // k steps consumed so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, Mo, No, n_step, &m0, &n0);
      const int rbase = m0 + cw * 64 + (t >> 5) * 16 + (lane >> 2);
      const int cbase = n0 + 2 * (lane & 3);
      // GU: the epilogue's own inputs for this thread's column pairs
      uint32_t pre[2][16];
      if constexpr (GU) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int r = rbase + 8 * h, c = cbase + 8 * j;
            pre[h][j] = (r < Mo && c < No) ? epi.fetch(r, c) : 0u;
          }
      }
      float acc[128];                        // the first product sets it
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        hw::mbar_wait(&full[s], (it / STAGES) & 1);
        const bf16* As =
            reinterpret_cast<const bf16*>(smem + s * STAGE_BYTES) + cw * BOX;
        const bf16* Bs =
            reinterpret_cast<const bf16*>(smem + s * STAGE_BYTES + A_BYTES);
        hw::fence_regs(acc);
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da =
              TA ? hw::desc_sw128(As + kk * 16 * 64, BOX * 2, 1024)
                 : hw::desc_sw128(As + kk * 16, 16, 1024);
          const uint64_t db =
              TB ? hw::desc_sw128(Bs + kk * 16, 16, 1024)
                 : hw::desc_sw128(Bs + kk * 16 * 64, BOX * 2, 1024);
          hw::wgmma_m64n256k16<TA ? 1 : 0, TB ? 0 : 1>(acc, da, db,
                                                       kt > 0 || kk > 0);
        }
        hw::wgmma_commit();
        hw::fence_regs(acc);
        // the products of the previous step have retired: release its stage
        hw::wgmma_wait<1>();
        if (kt > 0 && lane == 0) hw::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      if (KT > 0 && lane == 0) hw::mbar_arrive(&empty[(it - 1) % STAGES]);

      // epilogue from registers: d[4j + 2h + e] is row 16 warp + lane / 4
      // + 8h, column 8j + 2 (lane % 4) + e of this warpgroup's 64 x 256;
      // the two e columns go out as one pair where both are in range and
      // the row length is even (GU: always, M % 8 == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rbase + 8 * h;
        if (r >= Mo) continue;
        if constexpr (GU) {
          // columns 0-127 are gate columns, 128-255 the same up columns
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int c = cbase + 8 * j;
            const int g = 4 * j + 2 * h, u = g + 64;
            if (c < No)
              epi.pair(r, c, acc[g], acc[u], acc[g + 1], acc[u + 1],
                       pre[h][j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int c = cbase + 8 * j;
            const int v = 4 * j + 2 * h;
            if (even && c + 1 < No) {
              epi.pair(r, c, acc[v], acc[v + 1]);
            } else {
              if (c < No) epi(r, c, acc[v]);
              if (c + 1 < No) epi(r, c + 1, acc[v + 1]);
            }
          }
        }
      }
    }
  }
}

// ---------------- f32: register-tiled SIMT --------------------------------

constexpr int FT = 64, FM = 64, FK = 16;

template <class Epi>
__global__ void __launch_bounds__(256)
swiglu_simt_kernel(const float* __restrict__ a, const float* __restrict__ w,
                   int T, int H, int M, Epi epi) {
  __shared__ float As[FK][FT + 4];   // transposed: As[k][row]
  __shared__ float Gs[FK][FM + 4];
  __shared__ float Us[FK][FM + 4];

  const int r0 = blockIdx.y * FT;
  const int c0 = blockIdx.x * FM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;           // 4 output columns each
  const int ty = tid / 16;           // 4 output rows each
  const size_t ldw = 2 * static_cast<size_t>(M);

  float g[4][4], u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g[i][j] = 0.f;
      u[i][j] = 0.f;
    }

  for (int k0 = 0; k0 < H; k0 += FK) {
    for (int e = tid; e < FT * FK; e += blockDim.x) {
      const int r = e / FK;
      const int k = e % FK;
      const int gr = r0 + r;
      const int gk = k0 + k;
      As[k][r] = (gr < T && gk < H) ? a[static_cast<size_t>(gr) * H + gk]
                                    : 0.f;
    }
    for (int e = tid; e < FK * FM; e += blockDim.x) {
      const int k = e / FM;
      const int c = e % FM;
      const int gk = k0 + k;
      const int gc = c0 + c;
      const bool in = gk < H && gc < M;
      const size_t off = static_cast<size_t>(gk) * ldw + gc;
      Gs[k][c] = in ? w[off] : 0.f;
      Us[k][c] = in ? w[off + M] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float ar[4], gb[4], ub[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gb[j] = Gs[k][tx * 4 + j];
        ub[j] = Us[k][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = fmaf(ar[i], gb[j], g[i][j]);
          u[i][j] = fmaf(ar[i], ub[j], u[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + ty * 4 + i;
      const int gc = c0 + tx * 4 + j;
      if (gr < T && gc < M) epi(gr, gc, g[i][j], u[i][j]);
    }
}

// f32 C[Mo, No] = op(A) @ op(B), operand conventions as mma_kernel.
template <bool TA, bool TB>
__global__ void __launch_bounds__(256)
gemm_simt_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int Mo, int No, int K) {
  __shared__ float As[FK][FT + 4];   // As[k][row]
  __shared__ float Bs[FK][FM + 4];   // Bs[k][col]

  const int m0 = blockIdx.y * FT;
  const int n0 = blockIdx.x * FM;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int e = tid; e < FT * FK; e += blockDim.x) {
      // TA: consecutive threads walk the contiguous row index
      const int r = TA ? e % FT : e / FK;
      const int k = TA ? e / FT : e % FK;
      const int gm = m0 + r;
      const int gk = k0 + k;
      const bool in = gm < Mo && gk < K;
      As[k][r] = in ? (TA ? A[static_cast<size_t>(gk) * Mo + gm]
                          : A[static_cast<size_t>(gm) * K + gk])
                    : 0.f;
    }
    for (int e = tid; e < FK * FM; e += blockDim.x) {
      const int c = TB ? e / FK : e % FM;
      const int k = TB ? e % FK : e / FM;
      const int gn = n0 + c;
      const int gk = k0 + k;
      const bool in = gn < No && gk < K;
      Bs[k][c] = in ? (TB ? B[static_cast<size_t>(gn) * K + gk]
                          : B[static_cast<size_t>(gk) * No + gn])
                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gm = m0 + ty * 4 + i;
      const int gn = n0 + tx * 4 + j;
      if (gm < Mo && gn < No) C[static_cast<size_t>(gm) * No + gn] = acc[i][j];
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the forward at up to SMALL_T rows stays on mma_kernel (file note)
constexpr int SMALL_T = 128;

template <bool TA, bool TB, bool GU, class Epi>
int mma_sync_launch(const void* A, const void* B, int Mo, int No, int K,
                    int vec_ok, Epi epi, cudaStream_t stream) {
  auto kernel = mma_kernel<TA, TB, GU, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((No + (GU ? TN / 2 : TN) - 1) / (GU ? TN / 2 : TN),
            (Mo + TM - 1) / TM);
  kernel<<<grid, 256, MMA_SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B), Mo, No, K,
      vec_ok, epi);
  return static_cast<int>(cudaGetLastError());
}

// TMA maps of both operands (file note for the layouts), then the launch
template <bool TA, bool TB, bool GU, class Epi>
int wgmma_launch(const void* A, const void* B, int Mo, int No, int K,
                 Epi epi, cudaStream_t stream) {
  namespace hw = ptt::hopper;
  CUtensorMap map_a, map_b;
  int err = TA ? hw::tma_map_bf16(&map_a, A, K, Mo, 64)
               : hw::tma_map_bf16(&map_a, A, Mo, K, wg::BM);
  if (err != 0) return err;
  err = GU   ? hw::tma_map_bf16(&map_b, B, K, 2 * static_cast<uint64_t>(No), 64)
        : TB ? hw::tma_map_bf16(&map_b, B, No, K, wg::BN)
             : hw::tma_map_bf16(&map_b, B, K, No, 64);
  if (err != 0) return err;
  auto kernel = wgmma_swiglu_kernel<TA, TB, GU, Epi>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_step = GU ? wg::BN / 2 : wg::BN;
  const int tiles =
      ((Mo + wg::BM - 1) / wg::BM) * ((No + n_step - 1) / n_step);
  int device, sms;
  e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = tiles < sms ? tiles : sms;    // persistent blocks
  kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, stream>>>(map_a, map_b, Mo, No,
                                                        K, epi);
  return static_cast<int>(cudaGetLastError());
}

// Every bf16 product: the wgmma core where TMA can take the shape
// (vec_ok), mma_kernel's masked scalar loads where it cannot. The test is
// the only route decision; a failed encode or launch returns its error.
template <bool TA, bool TB, bool GU, class Epi>
int mma_launch(const void* A, const void* B, int Mo, int No, int K,
               int vec_ok, Epi epi, cudaStream_t stream) {
  if (vec_ok) return wgmma_launch<TA, TB, GU>(A, B, Mo, No, K, epi, stream);
  return mma_sync_launch<TA, TB, GU>(A, B, Mo, No, K, 0, epi, stream);
}

// gate/up main loop over a [T, H] x [H, 2M] problem with epilogue epi
// (forward: the launch of the forward itself, which at T <= SMALL_T rows
// takes mma_kernel's cp.async ring; the recompute in bwd_da never does)
template <class Epi>
int gu_bf16(const void* a, const void* w, int T, int H, int M, Epi epi,
            bool forward, cudaStream_t stream) {
  const int vec_ok = H > 0 && (H % 8 == 0) && (M % 8 == 0) && aligned16(a) &&
                     aligned16(w);
  if (forward && vec_ok && T <= SMALL_T)
    return mma_sync_launch<false, false, true>(a, w, T, M, H, vec_ok, epi,
                                               stream);
  return mma_launch<false, false, true>(a, w, T, M, H, vec_ok, epi, stream);
}

template <class Epi>
int gu_f32(const void* a, const void* w, int T, int H, int M, Epi epi,
           cudaStream_t stream) {
  dim3 grid((M + FM - 1) / FM, (T + FT - 1) / FT);
  swiglu_simt_kernel<Epi><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), T, H, M,
      epi);
  return static_cast<int>(cudaGetLastError());
}

template <bool TA, bool TB>
int gemm_bf16(const void* A, const void* B, void* C, int Mo, int No, int K,
              cudaStream_t stream) {
  // 16-byte copies need every staged row to be whole 8-element vectors:
  // row lengths are K (A, or B with TB), Mo (A with TA), No (B)
  const int a_row = TA ? Mo : K;
  const int b_row = TB ? K : No;
  const int vec_ok = (a_row % 8 == 0) && (b_row % 8 == 0) && aligned16(A) &&
                     aligned16(B);
  return mma_launch<TA, TB, false>(A, B, Mo, No, K, vec_ok,
                                   StoreEpi{static_cast<bf16*>(C), No},
                                   stream);
}

template <bool TA, bool TB>
int gemm_f32(const void* A, const void* B, void* C, int Mo, int No, int K,
             cudaStream_t stream) {
  dim3 grid((No + FM - 1) / FM, (Mo + FT - 1) / FT);
  gemm_simt_kernel<TA, TB><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(C), Mo, No, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_swiglu_bf16(const void* a, const void* w, void* out, int T,
                               int H, int M, void* stream) {
  if (T <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  return gu_bf16(a, w, T, H, M, FwdEpi<bf16>{static_cast<bf16*>(out), M},
                 true, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_swiglu_f32(const void* a, const void* w, void* out, int T,
                              int H, int M, void* stream) {
  if (T <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  return gu_f32(a, w, T, H, M, FwdEpi<float>{static_cast<float*>(out), M},
                static_cast<cudaStream_t>(stream));
}

// a [T, H], w [H, 2M], dout [T, M] -> dgu [T, 2M] (scratch the caller
// keeps for bwd_dw) and da [T, H]
extern "C" int ptt_swiglu_bwd_da_bf16(const void* a, const void* w,
                                      const void* dout, void* dgu, void* da,
                                      int T, int H, int M, void* stream) {
  if (T <= 0 || M <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  int err = gu_bf16(a, w, T, H, M,
                    DguEpi<bf16>{static_cast<const bf16*>(dout),
                                 static_cast<bf16*>(dgu), M},
                    false, st);
  if (err != 0) return err;
  return gemm_bf16<false, true>(dgu, w, da, T, H, 2 * M, st);
}

extern "C" int ptt_swiglu_bwd_da_f32(const void* a, const void* w,
                                     const void* dout, void* dgu, void* da,
                                     int T, int H, int M, void* stream) {
  if (T <= 0 || M <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  int err = gu_f32(a, w, T, H, M,
                   DguEpi<float>{static_cast<const float*>(dout),
                                 static_cast<float*>(dgu), M},
                   st);
  if (err != 0) return err;
  return gemm_f32<false, true>(dgu, w, da, T, H, 2 * M, st);
}

// a [T, H], dgu [T, 2M] -> dw [H, 2M]
extern "C" int ptt_swiglu_bwd_dw_bf16(const void* a, const void* dgu,
                                      void* dw, int T, int H, int M,
                                      void* stream) {
  if (T <= 0 || M <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  return gemm_bf16<true, false>(a, dgu, dw, H, 2 * M, T,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_swiglu_bwd_dw_f32(const void* a, const void* dgu, void* dw,
                                     int T, int H, int M, void* stream) {
  if (T <= 0 || M <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  return gemm_f32<true, false>(a, dgu, dw, H, 2 * M, T,
                               static_cast<cudaStream_t>(stream));
}
