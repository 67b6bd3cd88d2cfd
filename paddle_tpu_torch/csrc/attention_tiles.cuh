// Tile helpers shared by the attention kernels (flash_attention.cu,
// block_attention.cu): BSHD row copies into shared memory, mma.sync
// fragment loads and products over a 64-row tile (bf16), and the SIMT
// tile product with its shared-memory carve-out (f32).
#pragma once

#include "common.cuh"

namespace ptt {
namespace attn {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// ---- bf16: register-resident mma.sync tiles ----

constexpr int TQ = 64;               // q rows per tile (4 warps x 16)
constexpr int TKV = 64;              // kv rows per tile
constexpr int MMA_THREADS = 128;

// rows [r0, r0 + 64) of head h of batch b of a BSHD bf16 tensor with Hn
// heads into dst[64][D + 8] by 16-byte cp.async; rows past S are zero.
template <int D>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* __restrict__ src,
                                        int b, int h, int r0, int S, int Hn) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < 64 * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int s = r0 + r;
    const bool in = s < S;
    const bf16* g =
        in ? src + ((static_cast<size_t>(b) * S + s) * Hn + h) * D + c : src;
    ptt::cp_async16(dst + r * (D + 8) + c, g, in ? 16 : 0);
  }
}

// A fragment (16 rows x 16 of k) of a row-major bf16 tile [rows][ld]
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int ld, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ptt::ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

// B fragments of two n8 tiles (n0.., n0+8..) x 16 of k, from a tile
// stored [n][k] (k contiguous): b0 = n tile 0, b1 = n tile 1
__device__ __forceinline__ void ld_b_nk(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                        const bf16* tile, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  const int li = lane >> 3;
  uint32_t r[4];
  ptt::ldmatrix_x4(r, tile + (n0 + (lane & 7) + (li >> 1) * 8) * ld + k0 +
                          (li & 1) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// the same from a tile stored [k][n] (n contiguous), through .trans
__device__ __forceinline__ void ld_b_kn(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                        const bf16* tile, int ld, int n0,
                                        int k0) {
  const int lane = threadIdx.x & 31;
  const int li = lane >> 3;
  uint32_t r[4];
  ptt::ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + (li & 1) * 8) * ld +
                                n0 + (li >> 1) * 8);
  b0[0] = r[0];
  b0[1] = r[1];
  b1[0] = r[2];
  b1[1] = r[3];
}

// The accumulators of n8 tiles 2j and 2j+1 (16 rows x 16 columns), as
// the A fragment of the next product over those 16 columns, in bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = ptt::pack_bf16(c0[0], c0[1]);
  a[1] = ptt::pack_bf16(c0[2], c0[3]);
  a[2] = ptt::pack_bf16(c1[0], c1[1]);
  a[3] = ptt::pack_bf16(c1[2], c1[3]);
}

// C[16 x 8*NT] (+)= A[16 x 16*KS] B, A rows from `at` at row0, B from a
// tile stored [n][k] (`bt`, n from 0)
template <int NT, int KS>
__device__ __forceinline__ void mma_rows_nk(float (&c)[NT][4], const bf16* at,
                                            int lda, int row0, const bf16* bt,
                                            int ldb, int n0) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    ld_a(a, at, lda, row0, kk * 16);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0[2], b1[2];
      ld_b_nk(b0, b1, bt, ldb, n0 + np * 16, kk * 16);
      ptt::mma_bf16_16816(c[2 * np], a, b0);
      ptt::mma_bf16_16816(c[2 * np + 1], a, b1);
    }
  }
}

// C[16 x D] += P[16 x 16*KS] B where P is given as accumulators p (n8
// tiles over the k dimension) and B is a tile stored [k][n] from row k0
template <int ND, int KS>
__device__ __forceinline__ void mma_acc_kn(float (&c)[ND][4],
                                           const float (&p)[2 * KS][4],
                                           const bf16* bt, int ldb, int k0) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t a[4];
    acc_to_a(a, p[2 * j], p[2 * j + 1]);
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      uint32_t b0[2], b1[2];
      ld_b_kn(b0, b1, bt, ldb, np * 16, k0 + j * 16);
      ptt::mma_bf16_16816(c[2 * np], a, b0);
      ptt::mma_bf16_16816(c[2 * np + 1], a, b1);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- f32: SIMT tiles in shared memory ----

// C[M][N] (f32 in shared memory, leading dim ldc) = or += op(A) op(B).
// op(A) is [M][K]: stored row-major [M][K] (lda), or, with TA, stored
// [K][M]. op(B) is [K][N]: stored [K][N] (ldb), or, with TB, [N][K].
// Callers synchronise before and after.
template <bool TA, bool TB, int M, int N, int K>
__device__ void tile_mm(float* C, int ldc, const float* A, int lda,
                        const float* B, int ldb, bool accumulate) {
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int m = e / N;
    const int n = e % N;
    float s = accumulate ? C[m * ldc + n] : 0.f;
#pragma unroll 8
    for (int kk = 0; kk < K; ++kk)
      s = fmaf(TA ? A[kk * lda + m] : A[m * lda + kk],
               TB ? B[n * ldb + kk] : B[kk * ldb + n], s);
    C[m * ldc + n] = s;
  }
}

// Tile geometry for one head dim: 32 x 32 tiles, rows padded by 16 bytes.
template <int D>
struct Geo {
  static constexpr int BR = 32;      // q rows per tile
  static constexpr int BC = 32;      // kv rows per tile
  static constexpr int LDT = D + 4;  // q/k/v/dO tiles
  static constexpr int LDS = BC + 4; // score-shaped tiles
  static constexpr int LDO = D + 4;  // accumulators [*, D]
};

// Shared-memory carve-out: consecutive 128-byte-aligned buffers.
struct Carve {
  unsigned char* p;
  __device__ float* take(int elems) {
    float* out = reinterpret_cast<float*>(p);
    p += align128(elems * 4);
    return out;
  }
};

// rows [r0, r0 + R) of head h of batch b of a BSHD f32 tensor with Hn
// heads into dst[R][ld]; rows past S are zero.
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int b, int h, int r0, int S,
                                          int Hn) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < R * VPR; i += blockDim.x) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    const int s = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      v = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + s) * Hn + h) * D + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr int SIMT_THREADS = 256;

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace attn
}  // namespace ptt
