// SwiGLU forward: out[T, M] = silu(a @ Wg) * (a @ Wu), where
// w_gate_up = [Wg | Wu] is [H, 2M] (gate columns first). The [T, 2M]
// gate/up product is never stored: each block computes the g and u
// tiles of one [64, 64] output tile in f32 and applies silu(g) * u in
// the epilogue.
//
// Replaces: paddle_tpu/kernels/swiglu.py::swiglu (_fwd_impl ->
//   _fwd_kernel, the blockwise Pallas GEMM with the fused epilogue).
// Bound on the H100: at the serving slice's T = 128 rows, bytes — the
//   weight read (4096 x 22016 x 2 B = 180 MB per layer) against
//   2*128*4096*22016 = 23 GFLOP (128 flop per weight byte, under the
//   ~295 flop/byte bf16 ridge).
// Design: bf16 runs on the tensor cores through nvcuda::wmma 16x16x16
//   bf16 fragments with f32 accumulators, fed from shared-memory tiles
//   (64-row A tile, two 64-column B tiles at columns j and j+M, K step
//   32; 4 warps, each owning a 32x32 quadrant of both g and u). The K
//   loop is latency-bound when each step waits for its own loads, so
//   the tiles stream through a 3-slot cp.async ring: two K steps are in
//   flight while the tensor cores work on a third. Every weight element
//   is read from device memory once per 64-row block of a. Where the
//   shape allows 16-byte copies (H % 8 == 0, M % 8 == 0) the ring is
//   asynchronous with zero-fill at the edges; otherwise tiles load with
//   masked scalar loads, so any H and M work (llama_tiny's M = 688).
//   The f32 variant (the CPU-parity dtype) is a register-tiled SIMT GEMM
//   with the same epilogue: wmma has no full-precision f32 fragment.
//   Simple and right first; wgmma/TMA pipelines come later.

#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// ---------------- bf16: wmma tensor-core tiles ----------------------------

constexpr int BT = 64, BM = 64, BK = 32;
constexpr int STAGES = 3;            // cp.async ring: 2 tiles in flight
constexpr int LDA = BK + 8;          // bf16 elements, a multiple of 8
constexpr int LDB = BM + 8;
constexpr int LDC = BM + 4;          // f32 elements, a multiple of 4
constexpr int A_BYTES = BT * LDA * 2;
constexpr int B_BYTES = BK * LDB * 2;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int OPER_BYTES = STAGES * STAGE_BYTES;
constexpr int EPI_BYTES = 2 * BT * LDC * 4;
constexpr int SMEM_BYTES = OPER_BYTES > EPI_BYTES ? OPER_BYTES : EPI_BYTES;

// Stage one K step (A [64, 32], gate and up [32, 64]) into ring slot
// `st`. vec_ok (H % 8 == 0, M % 8 == 0, 16-byte aligned bases): 16-byte
// cp.async copies that zero-fill past the edges; else masked scalar
// loads through registers.
__device__ __forceinline__ void load_stage(
    unsigned char* smem, int st, const bf16* __restrict__ a,
    const bf16* __restrict__ w, int r0, int c0, int k0, int T, int H, int M,
    int vec_ok) {
  bf16* As = reinterpret_cast<bf16*>(smem + st * STAGE_BYTES);
  bf16* Gs = reinterpret_cast<bf16*>(smem + st * STAGE_BYTES + A_BYTES);
  bf16* Us = reinterpret_cast<bf16*>(smem + st * STAGE_BYTES + A_BYTES +
                                     B_BYTES);
  const size_t ldw = 2 * static_cast<size_t>(M);
  const bf16 zero = __float2bfloat16(0.f);
  for (int v = threadIdx.x; v < BT * BK / 8; v += blockDim.x) {
    const int r = v / (BK / 8);
    const int kc = (v % (BK / 8)) * 8;
    const int gr = r0 + r;
    const int gk = k0 + kc;
    bf16* dst = As + r * LDA + kc;
    if (vec_ok) {
      const bool in = gr < T && gk < H;      // H % 8 == 0: all 8 or none
      ptt::cp_async16(dst, in ? a + static_cast<size_t>(gr) * H + gk : a,
                      in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gr < T && gk + j < H)
                     ? a[static_cast<size_t>(gr) * H + gk + j]
                     : zero;
    }
  }
  for (int v = threadIdx.x; v < BK * BM / 8; v += blockDim.x) {
    const int kr = v / (BM / 8);
    const int cc = (v % (BM / 8)) * 8;
    const int gk = k0 + kr;
    const int gc = c0 + cc;
    bf16* dg = Gs + kr * LDB + cc;
    bf16* du = Us + kr * LDB + cc;
    if (vec_ok) {
      const bool in = gk < H && gc < M;      // M % 8 == 0: all 8 or none
      const bf16* src = in ? w + static_cast<size_t>(gk) * ldw + gc : w;
      ptt::cp_async16(dg, src, in ? 16 : 0);
      ptt::cp_async16(du, in ? src + M : w, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = gk < H && gc + j < M;
        const size_t off = static_cast<size_t>(gk) * ldw + gc + j;
        dg[j] = in ? w[off] : zero;
        du[j] = in ? w[off + M] : zero;
      }
    }
  }
}

__global__ void __launch_bounds__(128)
swiglu_wmma_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int T, int H, int M, int vec_ok) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];

  const int r0 = blockIdx.y * BT;
  const int c0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> g[2][2], u[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(g[i][j], 0.f);
      wmma::fill_fragment(u[i][j], 0.f);
    }

  const int KT = (H + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT)
      load_stage(smem, st, a, w, r0, c0, st * BK, T, H, M, vec_ok);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<STAGES - 2>();        // step kt has landed
    __syncthreads();                         // ... for every thread, and
                                             // step kt-1's slot is free
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(smem, nk % STAGES, a, w, r0, c0, nk * BK, T, H, M, vec_ok);
    ptt::cp_async_commit();

    const unsigned char* base = smem + (kt % STAGES) * STAGE_BYTES;
    const bf16* As = reinterpret_cast<const bf16*>(base);
    const bf16* Gs = reinterpret_cast<const bf16*>(base + A_BYTES);
    const bf16* Us = reinterpret_cast<const bf16*>(base + A_BYTES + B_BYTES);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bg[2],
          bu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wr + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bg[j], Gs + kk * LDB + wc + j * 16, LDB);
        wmma::load_matrix_sync(bu[j], Us + kk * LDB + wc + j * 16, LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(g[i][j], af[i], bg[j], g[i][j]);
          wmma::mma_sync(u[i][j], af[i], bu[j], u[i][j]);
        }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();                           // ring free: reuse for epilogue

  float* Gc = reinterpret_cast<float*>(smem);
  float* Uc = Gc + BT * LDC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int off = (wr + i * 16) * LDC + wc + j * 16;
      wmma::store_matrix_sync(Gc + off, g[i][j], LDC, wmma::mem_row_major);
      wmma::store_matrix_sync(Uc + off, u[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int e = threadIdx.x; e < BT * BM; e += blockDim.x) {
    const int r = e / BM;
    const int c = e % BM;
    const int gr = r0 + r;
    const int gc = c0 + c;
    if (gr < T && gc < M)
      out[static_cast<size_t>(gr) * M + gc] =
          __float2bfloat16(silu_mul(Gc[r * LDC + c], Uc[r * LDC + c]));
  }
}

// ---------------- f32: register-tiled SIMT --------------------------------

constexpr int FT = 64, FM = 64, FK = 16;

__global__ void __launch_bounds__(256)
swiglu_simt_kernel(const float* __restrict__ a, const float* __restrict__ w,
                   float* __restrict__ out, int T, int H, int M) {
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
      if (gr < T && gc < M)
        out[static_cast<size_t>(gr) * M + gc] = silu_mul(g[i][j], u[i][j]);
    }
}

}  // namespace

extern "C" int ptt_swiglu_bf16(const void* a, const void* w, void* out, int T,
                               int H, int M, void* stream) {
  if (T <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  const int vec_ok = (H % 8 == 0) && (M % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  dim3 grid((M + BM - 1) / BM, (T + BT - 1) / BT);
  swiglu_wmma_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), T, H, M, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptt_swiglu_f32(const void* a, const void* w, void* out, int T,
                              int H, int M, void* stream) {
  if (T <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid((M + FM - 1) / FM, (T + FT - 1) / FT);
  swiglu_simt_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(out), T, H, M);
  return static_cast<int>(cudaGetLastError());
}
