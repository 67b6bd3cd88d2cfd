// Flash attention forward and backward, BSHD layout, causal or full,
// MHA and GQA (q head h reads kv head h / (Hq / Hk)), head dim 64 or 128.
//
// Replaces: paddle_tpu/kernels/flash_attention.py::flash_attention_bshd
//   -> upstream jax/experimental/pallas/ops/tpu/flash_attention.py (fwd
//   pallas_call l.758, bwd dkv l.1121, bwd dq l.1456) for MHA, and the
//   splash MQA kernel (`_splash_gqa`) for GQA.
// Bound on the H100: operations. At the training slice's q/k/v
//   [4, 2048, 16, 128] causal, the forward does 4*B*H*S^2*D/2 = 69 GFLOP
//   against 67 MB of q/k/v/o (about 1000 flop per byte, far above the
//   ~295 flop/byte bf16 ridge); the backward does 2.5x the forward.
// Design: the TPU kernels carry the online-softmax state across a
//   sequential grid axis in VMEM scratch; here a block owns one (q tile,
//   head, batch) and walks the kv tiles in a loop inside the block, so
//   nothing crosses blocks. bf16 runs the FlashAttention-2 scheme on the
//   tensor cores: 4 warps each own 16 q rows; S = Q K^T, the online
//   softmax and the output accumulator stay in registers (mma.sync
//   m16n8k16, f32 accumulators), P is handed from the accumulator layout
//   straight to the A operand of P V, and K/V tiles stream through a
//   double-buffered cp.async ring. f32 (the CPU-parity dtype; the tensor
//   cores have no full-precision product) runs a SIMT version of the same
//   walk with its tiles in shared memory. P (and dS in the backward) is
//   rounded to the input dtype before its product, as every flash kernel
//   does; the softmax statistics stay f32. Fully masked causal tiles are
//   skipped, and the heavy causal tiles are scheduled first. The forward
//   writes O and the f32 log-sum-exp [B, H, S] for the backward. The
//   backward is two deterministic kernels (no atomics): dkv (one block per
//   kv tile, kv head and batch; it loops over the q tiles and, for GQA,
//   over the group's q heads, so dk and dv sum over the group in f32) and
//   dq (one block per q tile, head and batch). Both recompute P from the
//   saved LSE; D = rowsum(dO * O) comes from the caller (plain PyTorch
//   over the stored O, as upstream l.1664 does). `scale` multiplies the
//   scores in f32 (MHA); GQA callers pass q pre-scaled in q's dtype and
//   scale = 1, as splash takes it. wgmma/TMA pipelines come later.

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// ===================== bf16: register-resident mma.sync ===================

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

template <int D>
constexpr int fwd_mma_smem() {
  return 5 * TQ * (D + 8) * 2;       // Q, K x 2, V x 2
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int Hq, int Hk,
                     int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;         // k16 slices of the head dim
  constexpr int ND = D / 8;          // n8 tiles of the head dim
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TQ * LD;           // [2][64][LD]
  bf16* Vs = Ks + 2 * TKV * LD;      // [2][64][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * TQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  cp_rows<D>(Qs, q, b, h, q0, S, Hq);
  cp_rows<D>(Ks, k, b, hk, 0, S, Hk);
  cp_rows<D>(Vs, v, b, hk, 0, S, Hk);
  ptt::cp_async_commit();
  const int kv_end = causal ? min(S, q0 + TQ) : S;
  const int n_kv = (kv_end + TKV - 1) / TKV;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};         // this thread's share of the row sum

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1;
      cp_rows<D>(Ks + nb * TKV * LD, k, b, hk, (j + 1) * TKV, S, Hk);
      cp_rows<D>(Vs + nb * TKV * LD, v, b, hk, (j + 1) * TKV, S, Hk);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (j & 1) * TKV * LD;
    const bf16* Vb = Vs + (j & 1) * TKV * LD;

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    mma_rows_nk<8, KS>(s, Qs, LD, wr, Kb, LD, 0);

    const int k0 = j * TKV;
    const bool edge =
        (causal && k0 + TKV > q0) || k0 + TKV > S || q0 + TQ > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale;
        if (edge && !visible(q0 + wr + g + (e >> 1) * 8, k0 + i * 8 + t2 +
                             (e & 1), S, causal))
          x = -INFINITY;
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m_r[r] - m_use[r]);
      m_r[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[i][e] - m_use[e >> 1]);
        s[i][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    mma_acc_kn<ND, TKV / 16>(acc, s, Vb, LD, 0);
    __syncthreads();                 // buffer j & 1 is free for tile j + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] = quad_sum(l_r[r]);
    const int row = q0 + wr + g + r * 8;
    if (row >= S) continue;
    const float inv = 1.f / l_r[r];
    bf16* dst = o + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + t2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          ptt::pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if ((lane & 3) == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * S + row] =
          m_r[r] + logf(l_r[r]);
  }
}

template <int D>
constexpr int dq_mma_smem() {
  return 6 * TQ * (D + 8) * 2;       // Q, dO, K x 2, V x 2
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int S, int Hq, int Hk, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TQ * LD;
  bf16* Ks = dOs + TQ * LD;          // [2][64][LD]
  bf16* Vs = Ks + 2 * TKV * LD;      // [2][64][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * TQ;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  cp_rows<D>(Qs, q, b, h, q0, S, Hq);
  cp_rows<D>(dOs, dout, b, h, q0, S, Hq);
  cp_rows<D>(Ks, k, b, hk, 0, S, Hk);
  cp_rows<D>(Vs, v, b, hk, 0, S, Hk);
  ptt::cp_async_commit();
  // this thread's two rows: lse (+inf past S, so p = 0) and D
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    const size_t i = (static_cast<size_t>(b) * Hq + h) * S + row;
    lse_r[r] = row < S ? lse[i] : INFINITY;
    dl_r[r] = row < S ? delta[i] : 0.f;
  }
  const int kv_end = causal ? min(S, q0 + TQ) : S;
  const int n_kv = (kv_end + TKV - 1) / TKV;

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1;
      cp_rows<D>(Ks + nb * TKV * LD, k, b, hk, (j + 1) * TKV, S, Hk);
      cp_rows<D>(Vs + nb * TKV * LD, v, b, hk, (j + 1) * TKV, S, Hk);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + (j & 1) * TKV * LD;
    const bf16* Vb = Vs + (j & 1) * TKV * LD;

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = 0.f;
        dp[i][e] = 0.f;
      }
    mma_rows_nk<8, KS>(s, Qs, LD, wr, Kb, LD, 0);
    mma_rows_nk<8, KS>(dp, dOs, LD, wr, Vb, LD, 0);

    const int k0 = j * TKV;
    const bool edge =
        (causal && k0 + TKV > q0) || k0 + TKV > S || q0 + TQ > S;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool vis = !edge || visible(q0 + wr + g + r * 8,
                                          k0 + i * 8 + t2 + (e & 1), S,
                                          causal);
        const float p = vis ? expf(s[i][e] * scale - lse_r[r]) : 0.f;
        s[i][e] = p * (dp[i][e] - dl_r[r]);          // dS
      }
    mma_acc_kn<ND, TKV / 16>(acc, s, Kb, LD, 0);     // dQ += dS K
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= S) continue;
    bf16* dst = dq + ((static_cast<size_t>(b) * S + row) * Hq + h) * D + t2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          ptt::pack_bf16(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
}

template <int D>
constexpr int dkv_mma_smem() {
  return 6 * TQ * (D + 8) * 2 + 4 * TQ * 4;  // K, V, (Q, dO) x 2; lse, D x 2
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int Hq, int Hk, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int ND = D / 8;
  constexpr int QC = 32;             // q columns per register pass
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TKV * LD;
  bf16* Qs = Vs + TKV * LD;          // [2][64][LD]
  bf16* dOs = Qs + 2 * TQ * LD;      // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * TQ * LD);  // [2][64]
  float* dl_s = lse_s + 2 * TQ;                                // [2][64]

  const int k0 = blockIdx.x * TKV;   // early keys see the most q rows
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hk;
  const int lane = threadIdx.x & 31;
  const int wr = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;

  const int q_begin = causal ? k0 : 0;        // k0 is a multiple of TQ
  const int n_q = q_begin < S ? (S - q_begin + TQ - 1) / TQ : 0;
  const int total = group * n_q;

  // stage pass it (q head h = hk * group + it / n_q, q tile it % n_q)
  auto stage = [&](int it, int buf) {
    const int h = hk * group + it / n_q;
    const int q0 = q_begin + (it % n_q) * TQ;
    cp_rows<D>(Qs + buf * TQ * LD, q, b, h, q0, S, Hq);
    cp_rows<D>(dOs + buf * TQ * LD, dout, b, h, q0, S, Hq);
    for (int r = threadIdx.x; r < TQ; r += blockDim.x) {
      const int s = q0 + r;
      const size_t i = (static_cast<size_t>(b) * Hq + h) * S + s;
      lse_s[buf * TQ + r] = s < S ? lse[i] : INFINITY;
      dl_s[buf * TQ + r] = s < S ? delta[i] : 0.f;
    }
  };

  cp_rows<D>(Ks, k, b, hk, k0, S, Hk);
  cp_rows<D>(Vs, v, b, hk, k0, S, Hk);
  if (total > 0) stage(0, 0);
  ptt::cp_async_commit();

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[i][e] = 0.f;
      adv[i][e] = 0.f;
    }

  for (int it = 0; it < total; ++it) {
    if (it + 1 < total) {
      stage(it + 1, (it + 1) & 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
    } else {
      ptt::cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = it & 1;
    const bf16* Qb = Qs + buf * TQ * LD;
    const bf16* dOb = dOs + buf * TQ * LD;
    const float* lse_b = lse_s + buf * TQ;
    const float* dl_b = dl_s + buf * TQ;
    const int q0 = q_begin + (it % n_q) * TQ;
    const bool edge =
        (causal && q0 < k0 + TKV) || k0 + TKV > S || q0 + TQ > S;

#pragma unroll
    for (int qc = 0; qc < TQ; qc += QC) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x QC q's
      float st[QC / 8][4], dpt[QC / 8][4];
#pragma unroll
      for (int i = 0; i < QC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[i][e] = 0.f;
          dpt[i][e] = 0.f;
        }
      mma_rows_nk<QC / 8, KS>(st, Ks, LD, wr, Qb, LD, qc);
      mma_rows_nk<QC / 8, KS>(dpt, Vs, LD, wr, dOb, LD, qc);
#pragma unroll
      for (int i = 0; i < QC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = qc + i * 8 + t2 + (e & 1);   // column in the tile
          const bool vis = !edge || visible(q0 + qj, k0 + wr + g +
                                            (e >> 1) * 8, S, causal);
          const float p = vis ? expf(st[i][e] * scale - lse_b[qj]) : 0.f;
          st[i][e] = p;                                // P^T
          dpt[i][e] = p * (dpt[i][e] - dl_b[qj]);      // dS^T
        }
      mma_acc_kn<ND, QC / 16>(adv, st, dOb, LD, qc);   // dV += P^T dO
      mma_acc_kn<ND, QC / 16>(adk, dpt, Qb, LD, qc);   // dK += dS^T Q
    }
    __syncthreads();                 // buffer it & 1 is free for it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wr + g + r * 8;
    if (row >= S) continue;
    const size_t base = ((static_cast<size_t>(b) * S + row) * Hk + hk) * D + t2;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      *reinterpret_cast<uint32_t*>(dk + base + i * 8) =
          ptt::pack_bf16(adk[i][2 * r] * scale, adk[i][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + i * 8) =
          ptt::pack_bf16(adv[i][2 * r], adv[i][2 * r + 1]);
    }
  }
}

// ========================= f32: SIMT, shared memory ========================

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

template <int D>
constexpr int fwd_simt_smem() {
  using G = Geo<D>;
  return align128(G::BR * G::LDT * 4) + 2 * align128(G::BC * G::LDT * 4) +
         align128(G::BR * G::LDS * 4) * 2 + align128(G::BR * G::LDO * 4) +
         3 * align128(G::BR * 4);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int S, int Hq, int Hk,
                      int causal, float scale) {
  using G = Geo<D>;
  constexpr int BR = G::BR, BC = G::BC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take(BR * G::LDT);
  float* Ks = cv.take(BC * G::LDT);
  float* Vs = cv.take(BC * G::LDT);
  float* Ss = cv.take(BR * G::LDS);
  float* Ps = cv.take(BR * G::LDS);
  float* Os = cv.take(BR * G::LDO);
  float* m_s = cv.take(BR);
  float* l_s = cv.take(BR);
  float* a_s = cv.take(BR);

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, S, Hq);
  for (int e = threadIdx.x; e < BR * G::LDO; e += blockDim.x) Os[e] = 0.f;
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int kv_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();                 // the last tile's K, V, P are free
    load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, S, Hk);
    load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, S, Hk);
    __syncthreads();
    tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                    false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BR; r += nwarps) {
      const int qi = q0 + r;
      float mx = -INFINITY;
      for (int c = lane; c < BC; c += 32) {
        const float s = visible(qi, k0 + c, S, causal)
                            ? Ss[r * G::LDS + c] * scale
                            : -INFINITY;
        Ss[r * G::LDS + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = lane; c < BC; c += 32) {
        const float p = expf(Ss[r * G::LDS + c] - m_use);
        Ps[r * G::LDS + c] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BR * D; e += blockDim.x) {
      const int r = e / D;
      Os[r * G::LDO + e % D] *= a_s[r];
    }
    __syncthreads();
    tile_mm<false, false, BR, D, BC>(Os, G::LDO, Ps, G::LDS, Vs, G::LDT,
                                     true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BR * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e % D;
    const int s = q0 + r;
    if (s < S)
      o[((static_cast<size_t>(b) * S + s) * Hq + h) * D + c] =
          Os[r * G::LDO + c] / l_s[r];
  }
  for (int r = threadIdx.x; r < BR; r += blockDim.x)
    if (q0 + r < S)
      lse[(static_cast<size_t>(b) * Hq + h) * S + q0 + r] =
          m_s[r] + logf(l_s[r]);
}

// P and dS of one (q tile, kv tile) pair from the recomputed scores Ss and
// dP = dO V^T in dPs: p = exp(s * scale - lse), ds = p * (dp - D).
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Ss, const float* dPs,
                                         const float* lse_s,
                                         const float* dl_s, float* Ps,
                                         float* dSs, int q0, int k0, int S,
                                         int causal, float scale) {
  using G = Geo<D>;
  for (int e = threadIdx.x; e < G::BR * G::BC; e += blockDim.x) {
    const int r = e / G::BC;
    const int c = e % G::BC;
    const float p = visible(q0 + r, k0 + c, S, causal)
                        ? expf(Ss[r * G::LDS + c] * scale - lse_s[r])
                        : 0.f;
    if (Ps != nullptr) Ps[r * G::LDS + c] = p;
    dSs[r * G::LDS + c] = p * (dPs[r * G::LDS + c] - dl_s[r]);
  }
}

// lse and D rows of one q tile (rows past S: lse = +inf, so p = 0)
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int h, int q0, int S,
                                           int Hq, int BR) {
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    const int s = q0 + r;
    const size_t i = (static_cast<size_t>(b) * Hq + h) * S + s;
    lse_s[r] = s < S ? lse[i] : INFINITY;
    dl_s[r] = s < S ? delta[i] : 0.f;
  }
}

template <int D>
constexpr int dkv_simt_smem() {
  using G = Geo<D>;
  return 2 * align128(G::BC * G::LDT * 4) + 2 * align128(G::BC * G::LDO * 4) +
         2 * align128(G::BR * G::LDT * 4) + 4 * align128(G::BR * G::LDS * 4) +
         2 * align128(G::BR * 4);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int Hq, int Hk, int causal, float scale) {
  using G = Geo<D>;
  constexpr int BR = G::BR, BC = G::BC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Ks = cv.take(BC * G::LDT);
  float* Vs = cv.take(BC * G::LDT);
  float* dKs = cv.take(BC * G::LDO);
  float* dVs = cv.take(BC * G::LDO);
  float* Qs = cv.take(BR * G::LDT);
  float* dOs = cv.take(BR * G::LDT);
  float* Ss = cv.take(BR * G::LDS);
  float* dPs = cv.take(BR * G::LDS);
  float* Ps = cv.take(BR * G::LDS);
  float* dSs = cv.take(BR * G::LDS);
  float* lse_s = cv.take(BR);
  float* dl_s = cv.take(BR);

  const int k0 = blockIdx.x * BC;    // early keys see the most q rows
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hk;

  load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, S, Hk);
  load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, S, Hk);
  for (int e = threadIdx.x; e < BC * G::LDO; e += blockDim.x) {
    dKs[e] = 0.f;
    dVs[e] = 0.f;
  }
  const int q_begin = causal ? (k0 / BR) * BR : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int q0 = q_begin; q0 < S; q0 += BR) {
      __syncthreads();               // the last pair's Q, dO, P, dS are free
      load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, S, Hq);
      load_rows<BR, D>(dOs, G::LDT, dout, b, h, q0, S, Hq);
      load_stats(lse_s, dl_s, lse, delta, b, h, q0, S, Hq, BR);
      __syncthreads();
      tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                      false);
      tile_mm<false, true, BR, BC, D>(dPs, G::LDS, dOs, G::LDT, Vs, G::LDT,
                                      false);
      __syncthreads();
      p_and_ds<D>(Ss, dPs, lse_s, dl_s, Ps, dSs, q0, k0, S, causal, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q  (both [BC, D], summed over q rows)
      tile_mm<true, false, BC, D, BR>(dVs, G::LDO, Ps, G::LDS, dOs, G::LDT,
                                      true);
      tile_mm<true, false, BC, D, BR>(dKs, G::LDO, dSs, G::LDS, Qs, G::LDT,
                                      true);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BC * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e % D;
    const int s = k0 + r;
    if (s < S) {
      const size_t i = ((static_cast<size_t>(b) * S + s) * Hk + hk) * D + c;
      dk[i] = dKs[r * G::LDO + c] * scale;
      dv[i] = dVs[r * G::LDO + c];
    }
  }
}

template <int D>
constexpr int dq_simt_smem() {
  using G = Geo<D>;
  return 2 * align128(G::BR * G::LDT * 4) + 2 * align128(G::BC * G::LDT * 4) +
         align128(G::BR * G::LDO * 4) + 3 * align128(G::BR * G::LDS * 4) +
         2 * align128(G::BR * 4);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int S, int Hq, int Hk,
                         int causal, float scale) {
  using G = Geo<D>;
  constexpr int BR = G::BR, BC = G::BC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take(BR * G::LDT);
  float* dOs = cv.take(BR * G::LDT);
  float* Ks = cv.take(BC * G::LDT);
  float* Vs = cv.take(BC * G::LDT);
  float* dQs = cv.take(BR * G::LDO);
  float* Ss = cv.take(BR * G::LDS);
  float* dPs = cv.take(BR * G::LDS);
  float* dSs = cv.take(BR * G::LDS);
  float* lse_s = cv.take(BR);
  float* dl_s = cv.take(BR);

  const int qt = gridDim.x - 1 - blockIdx.x;   // heavy causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hk);
  const int q0 = qt * BR;

  load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, S, Hq);
  load_rows<BR, D>(dOs, G::LDT, dout, b, h, q0, S, Hq);
  load_stats(lse_s, dl_s, lse, delta, b, h, q0, S, Hq, BR);
  for (int e = threadIdx.x; e < BR * G::LDO; e += blockDim.x) dQs[e] = 0.f;
  const int kv_end = causal ? min(S, q0 + BR) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();                 // the last tile's K, V, dS are free
    load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, S, Hk);
    load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, S, Hk);
    __syncthreads();
    tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                    false);
    tile_mm<false, true, BR, BC, D>(dPs, G::LDS, dOs, G::LDT, Vs, G::LDT,
                                    false);
    __syncthreads();
    p_and_ds<D>(Ss, dPs, lse_s, dl_s, nullptr, dSs, q0, k0, S, causal,
                scale);
    __syncthreads();
    tile_mm<false, false, BR, D, BC>(dQs, G::LDO, dSs, G::LDS, Ks, G::LDT,
                                     true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BR * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e % D;
    const int s = q0 + r;
    if (s < S)
      dq[((static_cast<size_t>(b) * S + s) * Hq + h) * D + c] =
          dQs[r * G::LDO + c] * scale;
  }
}

// ------------------------------- launch ----------------------------------

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int S, int Hq, int Hk, int causal, float scale,
        cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = fwd_mma_smem<D>();
    cudaError_t err = set_smem(flash_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + TQ - 1) / TQ, Hq, B);
    flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o),
        static_cast<float*>(lse), S, Hq, Hk, causal, scale);
  } else {
    constexpr int smem = fwd_simt_smem<D>();
    cudaError_t err = set_smem(flash_fwd_simt_kernel<D>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + Geo<D>::BR - 1) / Geo<D>::BR, Hq, B);
    flash_fwd_simt_kernel<D><<<grid, SIMT_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), S, Hq, Hk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int S, int Hq, int Hk, int causal, float scale,
        cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  const float* lse_ = static_cast<const float*>(lse);
  const float* dl_ = static_cast<const float*>(delta);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem_kv = dkv_mma_smem<D>();
    err = set_smem(flash_bwd_dkv_mma_kernel<D>, smem_kv);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_mma_kernel<D>
        <<<dim3((S + TKV - 1) / TKV, Hk, B), MMA_THREADS, smem_kv, stream>>>(
            q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dk),
            static_cast<T*>(dv), S, Hq, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int smem_q = dq_mma_smem<D>();
    err = set_smem(flash_bwd_dq_mma_kernel<D>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_mma_kernel<D>
        <<<dim3((S + TQ - 1) / TQ, Hq, B), MMA_THREADS, smem_q, stream>>>(
            q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dq), S, Hq, Hk,
            causal, scale);
  } else {
    using G = Geo<D>;
    constexpr int smem_kv = dkv_simt_smem<D>();
    err = set_smem(flash_bwd_dkv_simt_kernel<D>, smem_kv);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dkv_simt_kernel<D>
        <<<dim3((S + G::BC - 1) / G::BC, Hk, B), SIMT_THREADS, smem_kv,
           stream>>>(q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dk),
                     static_cast<T*>(dv), S, Hq, Hk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    constexpr int smem_q = dq_simt_smem<D>();
    err = set_smem(flash_bwd_dq_simt_kernel<D>, smem_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_simt_kernel<D>
        <<<dim3((S + G::BR - 1) / G::BR, Hq, B), SIMT_THREADS, smem_q,
           stream>>>(q_, k_, v_, do_, lse_, dl_, static_cast<T*>(dq), S, Hq,
                     Hk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, void* o, void* lse,
            int B, int S, int Hq, int Hk, int D, int causal, float scale,
            void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64) return fwd<T, 64>(q, k, v, o, lse, B, S, Hq, Hk, causal,
                                 scale, st);
  if (D == 128) return fwd<T, 128>(q, k, v, o, lse, B, S, Hq, Hk, causal,
                                   scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_any(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, void* dk, void* dv,
            int B, int S, int Hq, int Hk, int D, int causal, float scale,
            void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (Hk <= 0 || Hq % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (D == 64) return bwd<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                 S, Hq, Hk, causal, scale, st);
  if (D == 128) return bwd<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                   S, Hq, Hk, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ptt_flash_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int S, int Hq, int Hk,
                                            int D, int causal, float scale,
                                            void* stream) {
  return fwd_any<bf16>(q, k, v, o, lse, B, S, Hq, Hk, D, causal, scale,
                       stream);
}

extern "C" int ptt_flash_attention_fwd_f32(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int S, int Hq, int Hk,
                                           int D, int causal, float scale,
                                           void* stream) {
  return fwd_any<float>(q, k, v, o, lse, B, S, Hq, Hk, D, causal, scale,
                        stream);
}

extern "C" int ptt_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int S, int Hq, int Hk, int D, int causal, float scale, void* stream) {
  return bwd_any<bf16>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq, Hk,
                       D, causal, scale, stream);
}

extern "C" int ptt_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int S, int Hq, int Hk, int D, int causal, float scale, void* stream) {
  return bwd_any<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, Hq, Hk,
                        D, causal, scale, stream);
}
