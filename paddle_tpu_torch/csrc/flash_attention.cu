// Flash attention with a bias, forward and backward, BSHD layout, causal
// (top-left) or full, MHA and GQA (q head h reads kv head h / (Hq /
// Hk)), head dim 64 or 128, q and kv lengths Sq and Sk of their own: the
// bias route (`ptt_flash_attention_bias_*`), bf16 on mma.sync, f32 on
// SIMT. Every route without a bias (the one-length route of LLaMA
// training and ERNIE, the segment route of padding masks, packed
// documents and cross lengths) runs the TMA + mbarrier + wgmma core of
// flash_wgmma.cu, bf16 and f32 (as 3xTF32): mma.sync m16n8k16 issued by
// single warps from a cp.async ring cannot reach Hopper's tensor-core
// rate (3.8x SDPA's forward at llama_7b's shape on an H100, PERF.md row
// 10), and FMA loops over shared-memory tiles reach a small part of the
// f32 rate (4.8x SDPA's f32 backward at ERNIE's shape, PERF.md row 10).
//
// Replaces: paddle_tpu/kernels/flash_attention.py:215
//   (`flash_attention_biased`, below) -> the block-stats kernel of
//   kernels/block_attention.py:138 per 512-key chunk.
// Bound on the H100: operations at the 7B shape (alibi causal [4, 2048,
//   32, 128]: 137 GFLOP of causal pairs against 67 MB); causal tiles
//   above the diagonal are skipped.
// Design: the TPU kernels carry the online-softmax state across a
//   sequential grid axis in VMEM scratch; here a block owns one (q tile,
//   head, batch) and walks the kv tiles in a loop inside the block, so
//   nothing crosses blocks. bf16 runs the FlashAttention-2 scheme on the
//   tensor cores: 4 warps each own 16 q rows; S = Q K^T, the online
//   softmax and the output accumulator stay in registers (mma.sync
//   m16n8k16, f32 accumulators), P is handed from the accumulator layout
//   straight to the A operand of P V, and K/V tiles stream through a
//   double-buffered cp.async ring. f32 runs a SIMT version of the same
//   walk with its tiles in shared memory. P (and dS in the backward) is
//   rounded to the input dtype before its product, as every flash kernel
//   does; the softmax statistics stay f32. Fully masked causal tiles are
//   skipped, and the heavy causal tiles are scheduled first. The forward
//   writes O and the f32 log-sum-exp [B, H, Sq] for the backward. The
//   backward is two deterministic kernels (no atomics): dkv (one block per
//   kv tile, kv head and batch; it loops over the q tiles and, for GQA,
//   over the group's q heads, so dk and dv sum over the group in f32) and
//   dq (one block per q tile, head and batch). Both recompute P from the
//   saved LSE; D = rowsum(dO * O) is plain PyTorch over the stored O, as
//   upstream l.1664 is plain jnp. `scale` multiplies the scores in f32,
//   GQA included.
// The bias: one forward and one dkv/dq pair (the reference runs the
//   block-stats kernel per 512-key chunk and merges the partials), with
//   the bias made or read inside the kernel at the score assembly, never
//   materialised: "alibi" from the head's slope (-slope (i - j) causal,
//   -slope |i - j| full), "rel_table" from the head's table row
//   (table[h, clip(j - i, -R, R) + R], read through the read-only
//   cache), "dense" read in place through four element strides (0 where
//   it broadcasts). The kind is a runtime value uniform over the grid,
//   so one instantiation serves all three. x = s * scale + bias in f32,
//   each step rounded as the plain version rounds it (no fused
//   multiply-add); scale multiplies the f32 scores for GQA too. An entry
//   is masked (P = 0 exactly) past Sk, above the top-left causal
//   diagonal (j > i, any Sq and Sk), at a padding-mask key, or where the
//   bias is <= -5e29 (-inf included); a finite bias such as -1e4 is a
//   number. A row with no valid key writes o = 0 and lse = +inf, so its
//   backward P is 0.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using namespace ptt::attn;

__device__ __forceinline__ bool in_view(int qi, int kj, int Sq, int Sk,
                                        int causal) {
  return qi < Sq && kj < Sk && (!causal || kj <= qi);
}

// bias kinds (a runtime value, uniform over the grid)
constexpr int kBiasAlibi = 1;
constexpr int kBiasRelTable = 2;
constexpr int kBiasDense = 3;
constexpr float kMaskedBias = -5e29f;  // the reference's 0.5 * _NEG

struct BiasArgs {
  int kind;
  int R;                             // rel_table: the table's radius
  const float* p;                    // slopes [Hq] | table [Hq][2R+1] | dense
  const unsigned char* kv_valid;     // [B, Sk], 0 = padding; or nullptr
  long long sb, sh, sq, sk;          // dense: element strides
};

// what one (batch, q head) reads of the bias
struct BiasHead {
  float slope;                       // alibi
  const float* row;                  // rel_table: the head's table row;
                                     // dense: the (b, h) plane
  const unsigned char* valid;        // the batch row's padding mask
};

__device__ __forceinline__ BiasHead bias_head(const BiasArgs& a, int b,
                                              int h, int Sk) {
  BiasHead hb{0.f, nullptr, nullptr};
  if (a.kind == kBiasAlibi)
    hb.slope = __ldg(a.p + h);
  else if (a.kind == kBiasRelTable)
    hb.row = a.p + static_cast<size_t>(h) * (2 * a.R + 1);
  else
    hb.row = a.p + b * a.sb + h * a.sh;
  if (a.kv_valid != nullptr)
    hb.valid = a.kv_valid + static_cast<size_t>(b) * Sk;
  return hb;
}

// the bias of score (qi, kj) of one head into bv (qi < Sq, kj < Sk);
// false when the entry is masked: a padding key, or a bias <= -5e29
__device__ __forceinline__ bool bias_at(float& bv, const BiasArgs& a,
                                        const BiasHead& hb, int qi, int kj,
                                        int causal) {
  if (hb.valid != nullptr && !hb.valid[kj]) return false;
  if (a.kind == kBiasAlibi) {
    const float d = static_cast<float>(qi - kj);
    bv = __fmul_rn(-hb.slope, causal ? d : fabsf(d));
  } else if (a.kind == kBiasRelTable) {
    bv = __ldg(hb.row + min(max(kj - qi, -a.R), a.R) + a.R);
  } else {
    bv = __ldg(hb.row + qi * a.sq + kj * a.sk);
  }
  return bv > kMaskedBias;
}

// x = s * scale + bias, rounded at each step as the plain version is
__device__ __forceinline__ float biased(float s, float scale, float bv) {
  return __fadd_rn(__fmul_rn(s, scale), bv);
}

// s <- s * scale + bias over this thread's elements of one mma score
// tile, -inf where masked (out of view, a padding key, a bias <= -5e29).
// Element (i, e) lies in row rw[e >> 1] and column c0 + i * 8 + (e & 1);
// KQ: rows are keys and columns queries (the dkv kernel's S^T). The kind
// is switched once per tile, not per element; the view is tested on edge
// tiles only (`edge`: the tile crosses Sq, Sk or the causal diagonal).
#define PTT_BIAS_LOOP(EXPR)                                                 \
  _Pragma("unroll") for (int i = 0; i < NT; ++i) {                          \
    _Pragma("unroll") for (int e = 0; e < 4; ++e) {                         \
      const int row = rw[e >> 1];                                           \
      const int col = c0 + i * 8 + (e & 1);                                 \
      const int qi = KQ ? col : row;                                        \
      const int kj = KQ ? row : col;                                        \
      float bv = -INFINITY;                                                 \
      if ((!edge || in_view(qi, kj, Sq, Sk, causal)) &&                     \
          (hb.valid == nullptr || hb.valid[kj])) {                          \
        bv = (EXPR);                                                        \
        if (!(bv > kMaskedBias)) bv = -INFINITY;                            \
      }                                                                     \
      s[i][e] = biased(s[i][e], scale, bv);                                 \
    }                                                                       \
  }

template <int NT, bool KQ>
__device__ __forceinline__ void bias_scores(float (&s)[NT][4], float scale,
                                            const BiasArgs& a,
                                            const BiasHead& hb,
                                            const int (&rw)[2], int c0,
                                            int Sq, int Sk, int causal,
                                            bool edge) {
  if (a.kind == kBiasAlibi) {
    const float ns = -hb.slope;
    PTT_BIAS_LOOP(__fmul_rn(ns, causal ? static_cast<float>(qi - kj)
                                       : fabsf(static_cast<float>(qi - kj))))
  } else if (a.kind == kBiasRelTable) {
    PTT_BIAS_LOOP(__ldg(hb.row + min(max(kj - qi, -a.R), a.R) + a.R))
  } else {
    PTT_BIAS_LOOP(__ldg(hb.row + qi * a.sq + kj * a.sk))
  }
}

#undef PTT_BIAS_LOOP

// ===================== bf16: register-resident mma.sync ===================

template <int D>
constexpr int fwd_mma_smem() {
  return 5 * TQ * (D + 8) * 2;       // Q, K x 2, V x 2
}

// the bias forward (the segment forward runs flash_wgmma.cu)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const BiasArgs ba,
                     bf16* __restrict__ o, float* __restrict__ lse, int Sq,
                     int Sk, int Hq, int Hk, int causal, float scale) {
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

  cp_rows<D>(Qs, q, b, h, q0, Sq, Hq);
  cp_rows<D>(Ks, k, b, hk, 0, Sk, Hk);
  cp_rows<D>(Vs, v, b, hk, 0, Sk, Hk);
  ptt::cp_async_commit();
  const int kv_end = causal ? min(Sk, q0 + TQ) : Sk;
  const int n_kv = (kv_end + TKV - 1) / TKV;
  const BiasHead hb = bias_head(ba, b, h, Sk);
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};  // its two q rows

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
      cp_rows<D>(Ks + nb * TKV * LD, k, b, hk, (j + 1) * TKV, Sk, Hk);
      cp_rows<D>(Vs + nb * TKV * LD, v, b, hk, (j + 1) * TKV, Sk, Hk);
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
    const bool edge = (causal && k0 + TKV > q0) || k0 + TKV > Sk ||
                      q0 + TQ > Sq;
    bias_scores<8, false>(s, scale, ba, hb, rows, k0 + t2, Sq, Sk, causal,
                          edge);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
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
    if (row >= Sq) continue;
    float inv = 1.f / l_r[r];
    float lse_v = m_r[r] + logf(l_r[r]);
    // a row with no valid key: o = 0, lse = +inf (backward P = 0)
    if (!(l_r[r] > 0.f)) { inv = 0.f; lse_v = INFINITY; }
    bf16* dst = o + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + t2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          ptt::pack_bf16(acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
    if ((lane & 3) == 0)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + row] = lse_v;
  }
}

template <int D>
constexpr int dq_mma_smem() {
  return 6 * TQ * (D + 8) * 2;       // Q, dO, K x 2, V x 2
}

// the bias backward's dq (the segment backward runs flash_wgmma.cu)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, const BiasArgs ba,
                        bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hk,
                        int causal, float scale) {
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

  cp_rows<D>(Qs, q, b, h, q0, Sq, Hq);
  cp_rows<D>(dOs, dout, b, h, q0, Sq, Hq);
  cp_rows<D>(Ks, k, b, hk, 0, Sk, Hk);
  cp_rows<D>(Vs, v, b, hk, 0, Sk, Hk);
  ptt::cp_async_commit();
  // this thread's two rows: lse (+inf past Sq, so p = 0), D
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + row;
    lse_r[r] = row < Sq ? lse[i] : INFINITY;
    dl_r[r] = row < Sq ? delta[i] : 0.f;
  }
  const int kv_end = causal ? min(Sk, q0 + TQ) : Sk;
  const int n_kv = (kv_end + TKV - 1) / TKV;
  const BiasHead hb = bias_head(ba, b, h, Sk);
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};  // its two q rows

  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1;
      cp_rows<D>(Ks + nb * TKV * LD, k, b, hk, (j + 1) * TKV, Sk, Hk);
      cp_rows<D>(Vs + nb * TKV * LD, v, b, hk, (j + 1) * TKV, Sk, Hk);
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
    const bool edge = (causal && k0 + TKV > q0) || k0 + TKV > Sk ||
                      q0 + TQ > Sq;
    // the biased scores, -inf where masked: P = 0 there exactly
    bias_scores<8, false>(s, scale, ba, hb, rows, k0 + t2, Sq, Sk, causal,
                          edge);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(s[i][e] - lse_r[r]);
        s[i][e] = p * (dp[i][e] - dl_r[r]);            // dS
      }
    mma_acc_kn<ND, TKV / 16>(acc, s, Kb, LD, 0);     // dQ += dS K
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + r * 8;
    if (row >= Sq) continue;
    bf16* dst = dq + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D + t2;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<uint32_t*>(dst + i * 8) =
          ptt::pack_bf16(acc[i][2 * r] * scale, acc[i][2 * r + 1] * scale);
  }
}

template <int D>
constexpr int dkv_mma_smem() {
  // K, V, (Q, dO) x 2; lse, D x 2
  return 6 * TQ * (D + 8) * 2 + 4 * TQ * 4;
}

// the bias backward's dk and dv (the segment backward runs flash_wgmma.cu)
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, const BiasArgs ba,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
                         int Sk, int Hq, int Hk, int causal, float scale) {
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

  const int kv_rows[2] = {k0 + wr + g, k0 + wr + g + 8};  // its kv rows
  const int q_begin = causal ? k0 : 0;        // k0 is a multiple of TQ
  const int n_q = q_begin < Sq ? (Sq - q_begin + TQ - 1) / TQ : 0;
  const int total = group * n_q;

  // stage pass it (q head h = hk * group + it / n_q, q tile it % n_q)
  auto stage = [&](int it, int buf) {
    const int h = hk * group + it / n_q;
    const int q0 = q_begin + (it % n_q) * TQ;
    cp_rows<D>(Qs + buf * TQ * LD, q, b, h, q0, Sq, Hq);
    cp_rows<D>(dOs + buf * TQ * LD, dout, b, h, q0, Sq, Hq);
    for (int r = threadIdx.x; r < TQ; r += blockDim.x) {
      const int s = q0 + r;
      const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + s;
      lse_s[buf * TQ + r] = s < Sq ? lse[i] : INFINITY;
      dl_s[buf * TQ + r] = s < Sq ? delta[i] : 0.f;
    }
  };

  cp_rows<D>(Ks, k, b, hk, k0, Sk, Hk);
  cp_rows<D>(Vs, v, b, hk, k0, Sk, Hk);
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
    const bool edge = (causal && q0 < k0 + TKV) || k0 + TKV > Sk ||
                      q0 + TQ > Sq;
    const BiasHead hb = bias_head(ba, b, hk * group + it / n_q, Sk);

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
      // the biased scores, -inf where masked: P = 0 there exactly
      bias_scores<QC / 8, true>(st, scale, ba, hb, kv_rows, q0 + qc + t2,
                                Sq, Sk, causal, edge);
#pragma unroll
      for (int i = 0; i < QC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qj = qc + i * 8 + t2 + (e & 1);   // column in the tile
          const float p = expf(st[i][e] - lse_b[qj]);
          st[i][e] = p;                                // P^T
          dpt[i][e] = p * (dpt[i][e] - dl_b[qj]);      // dS^T
        }
      mma_acc_kn<ND, QC / 16>(adv, st, dOb, LD, qc);   // dV += P^T dO
      mma_acc_kn<ND, QC / 16>(adk, dpt, Qb, LD, qc);   // dK += dS^T Q
    }
    __syncthreads();                 // buffer it & 1 is free for it + 2
  }
  // causal with Sq < Sk: keys past the last query see none, and the K/V
  // copies were never waited for
  if (total == 0) ptt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wr + g + r * 8;
    if (row >= Sk) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sk + row) * Hk + hk) * D + t2;
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

template <int D>
constexpr int fwd_simt_smem() {
  using G = Geo<D>;
  return align128(G::BR * G::LDT * 4) + 2 * align128(G::BC * G::LDT * 4) +
         align128(G::BR * G::LDS * 4) * 2 + align128(G::BR * G::LDO * 4) +
         3 * align128(G::BR * 4);
}

// the f32 bias forward
template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const BiasArgs ba,
                      float* __restrict__ o, float* __restrict__ lse, int Sq,
                      int Sk, int Hq, int Hk, int causal, float scale) {
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
  const BiasHead hb = bias_head(ba, b, h, Sk);

  load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, Sq, Hq);
  for (int e = threadIdx.x; e < BR * G::LDO; e += blockDim.x) Os[e] = 0.f;
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  const int kv_end = causal ? min(Sk, q0 + BR) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();                 // the last tile's K, V, P are free
    load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, Sk, Hk);
    load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, Sk, Hk);
    __syncthreads();
    tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                    false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BR; r += nwarps) {
      const int qi = q0 + r;
      float mx = -INFINITY;
      for (int c = lane; c < BC; c += 32) {
        float s = -INFINITY, bv;
        if (in_view(qi, k0 + c, Sq, Sk, causal) &&
            bias_at(bv, ba, hb, qi, k0 + c, causal))
          s = biased(Ss[r * G::LDS + c], scale, bv);
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
    // a row with no valid key (l = 0) writes o = 0 and lse = +inf
    if (s < Sq)
      o[((static_cast<size_t>(b) * Sq + s) * Hq + h) * D + c] =
          !(l_s[r] > 0.f) ? 0.f : Os[r * G::LDO + c] / l_s[r];
  }
  for (int r = threadIdx.x; r < BR; r += blockDim.x)
    if (q0 + r < Sq)
      lse[(static_cast<size_t>(b) * Hq + h) * Sq + q0 + r] =
          !(l_s[r] > 0.f) ? INFINITY : m_s[r] + logf(l_s[r]);
}

// P and dS of one (q tile, kv tile) pair from the recomputed scores Ss and
// dP = dO V^T in dPs: p = exp(s * scale + the head's bias - lse), 0 where
// masked; ds = p * (dp - D).
template <int D>
__device__ __forceinline__ void p_and_ds(const float* Ss, const float* dPs,
                                         const float* lse_s,
                                         const float* dl_s, const BiasArgs& ba,
                                         const BiasHead& hb, float* Ps,
                                         float* dSs, int q0, int k0, int Sq,
                                         int Sk, int causal, float scale) {
  using G = Geo<D>;
  for (int e = threadIdx.x; e < G::BR * G::BC; e += blockDim.x) {
    const int r = e / G::BC;
    const int c = e % G::BC;
    float p = 0.f, bv;
    if (in_view(q0 + r, k0 + c, Sq, Sk, causal) &&
        bias_at(bv, ba, hb, q0 + r, k0 + c, causal))
      p = expf(biased(Ss[r * G::LDS + c], scale, bv) - lse_s[r]);
    if (Ps != nullptr) Ps[r * G::LDS + c] = p;
    dSs[r * G::LDS + c] = p * (dPs[r * G::LDS + c] - dl_s[r]);
  }
}

// lse and D rows of one q tile (rows past Sq: lse = +inf, so p = 0)
__device__ __forceinline__ void load_stats(float* lse_s, float* dl_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int b, int h, int q0, int Sq,
                                           int Hq, int BR) {
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    const int s = q0 + r;
    const size_t i = (static_cast<size_t>(b) * Hq + h) * Sq + s;
    lse_s[r] = s < Sq ? lse[i] : INFINITY;
    dl_s[r] = s < Sq ? delta[i] : 0.f;
  }
}

template <int D>
constexpr int dkv_simt_smem() {
  using G = Geo<D>;
  return 2 * align128(G::BC * G::LDT * 4) + 2 * align128(G::BC * G::LDO * 4) +
         2 * align128(G::BR * G::LDT * 4) + 4 * align128(G::BR * G::LDS * 4) +
         2 * align128(G::BR * 4);
}

// the f32 bias backward's dk and dv
template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dkv_simt_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, const BiasArgs ba,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int Sq, int Sk, int Hq, int Hk, int causal,
                          float scale) {
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

  load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, Sk, Hk);
  load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, Sk, Hk);
  for (int e = threadIdx.x; e < BC * G::LDO; e += blockDim.x) {
    dKs[e] = 0.f;
    dVs[e] = 0.f;
  }
  const int q_begin = causal ? (k0 / BR) * BR : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const BiasHead hb = bias_head(ba, b, h, Sk);
    for (int q0 = q_begin; q0 < Sq; q0 += BR) {
      __syncthreads();               // the last pair's Q, dO, P, dS are free
      load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, Sq, Hq);
      load_rows<BR, D>(dOs, G::LDT, dout, b, h, q0, Sq, Hq);
      load_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, Hq, BR);
      __syncthreads();
      tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                      false);
      tile_mm<false, true, BR, BC, D>(dPs, G::LDS, dOs, G::LDT, Vs, G::LDT,
                                      false);
      __syncthreads();
      p_and_ds<D>(Ss, dPs, lse_s, dl_s, ba, hb, Ps, dSs, q0, k0, Sq, Sk,
                  causal, scale);
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
    if (s < Sk) {
      const size_t i = ((static_cast<size_t>(b) * Sk + s) * Hk + hk) * D + c;
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

// the f32 bias backward's dq
template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
flash_bwd_dq_simt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, const BiasArgs ba,
                         float* __restrict__ dq, int Sq, int Sk, int Hq,
                         int Hk, int causal, float scale) {
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
  const BiasHead hb = bias_head(ba, b, h, Sk);

  load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, Sq, Hq);
  load_rows<BR, D>(dOs, G::LDT, dout, b, h, q0, Sq, Hq);
  load_stats(lse_s, dl_s, lse, delta, b, h, q0, Sq, Hq, BR);
  for (int e = threadIdx.x; e < BR * G::LDO; e += blockDim.x) dQs[e] = 0.f;
  const int kv_end = causal ? min(Sk, q0 + BR) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();                 // the last tile's K, V, dS are free
    load_rows<BC, D>(Ks, G::LDT, k, b, hk, k0, Sk, Hk);
    load_rows<BC, D>(Vs, G::LDT, v, b, hk, k0, Sk, Hk);
    __syncthreads();
    tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                    false);
    tile_mm<false, true, BR, BC, D>(dPs, G::LDS, dOs, G::LDT, Vs, G::LDT,
                                    false);
    __syncthreads();
    p_and_ds<D>(Ss, dPs, lse_s, dl_s, ba, hb, nullptr, dSs, q0, k0, Sq, Sk,
                causal, scale);
    __syncthreads();
    tile_mm<false, false, BR, D, BC>(dQs, G::LDO, dSs, G::LDS, Ks, G::LDT,
                                     true);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BR * D; e += blockDim.x) {
    const int r = e / D;
    const int c = e % D;
    const int s = q0 + r;
    if (s < Sq)
      dq[((static_cast<size_t>(b) * Sq + s) * Hq + h) * D + c] =
          dQs[r * G::LDO + c] * scale;
  }
}

// ------------------------------- launch ----------------------------------

struct Shape {
  int B, Sq, Sk, Hq, Hk, causal;
  float scale;
};

// the bias forward: bf16 on the mma.sync kernel, f32 on SIMT
template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v,
                const BiasArgs& ba, void* o, void* lse, const Shape& s,
                cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = fwd_mma_smem<D>();
    cudaError_t err = set_smem(flash_fwd_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((s.Sq + TQ - 1) / TQ, s.Hq, s.B);
    flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), ba, static_cast<bf16*>(o),
        static_cast<float*>(lse), s.Sq, s.Sk, s.Hq, s.Hk, s.causal, s.scale);
  } else {
    constexpr int smem = fwd_simt_smem<D>();
    cudaError_t err = set_smem(flash_fwd_simt_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((s.Sq + Geo<D>::BR - 1) / Geo<D>::BR, s.Hq, s.B);
    flash_fwd_simt_kernel<D><<<grid, SIMT_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), ba, static_cast<float*>(o),
        static_cast<float*>(lse), s.Sq, s.Sk, s.Hq, s.Hk, s.causal, s.scale);
  }
  return cudaGetLastError();
}

// the backward's inputs: q, k, v, dout (T) and lse, delta (f32)
struct BwdIn {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
};

template <typename T, int D>
cudaError_t dkv(const BwdIn& in, const BiasArgs& ba, void* dk, void* dv,
                const Shape& s, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(in.q);
  const T* k_ = static_cast<const T*>(in.k);
  const T* v_ = static_cast<const T*>(in.v);
  const T* do_ = static_cast<const T*>(in.dout);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dkv_mma_smem<D>();
    err = set_smem(flash_bwd_dkv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_mma_kernel<D>
        <<<dim3((s.Sk + TKV - 1) / TKV, s.Hk, s.B), MMA_THREADS, smem,
           stream>>>(q_, k_, v_, do_, in.lse, in.delta, ba,
                     static_cast<T*>(dk), static_cast<T*>(dv), s.Sq, s.Sk,
                     s.Hq, s.Hk, s.causal, s.scale);
  } else {
    constexpr int smem = dkv_simt_smem<D>();
    err = set_smem(flash_bwd_dkv_simt_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_simt_kernel<D>
        <<<dim3((s.Sk + Geo<D>::BC - 1) / Geo<D>::BC, s.Hk, s.B),
           SIMT_THREADS, smem, stream>>>(
            q_, k_, v_, do_, in.lse, in.delta, ba, static_cast<T*>(dk),
            static_cast<T*>(dv), s.Sq, s.Sk, s.Hq, s.Hk, s.causal, s.scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const BwdIn& in, const BiasArgs& ba, void* dq_out,
               const Shape& s, cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(in.q);
  const T* k_ = static_cast<const T*>(in.k);
  const T* v_ = static_cast<const T*>(in.v);
  const T* do_ = static_cast<const T*>(in.dout);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dq_mma_smem<D>();
    err = set_smem(flash_bwd_dq_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_mma_kernel<D>
        <<<dim3((s.Sq + TQ - 1) / TQ, s.Hq, s.B), MMA_THREADS, smem,
           stream>>>(q_, k_, v_, do_, in.lse, in.delta, ba,
                     static_cast<T*>(dq_out), s.Sq, s.Sk, s.Hq, s.Hk,
                     s.causal, s.scale);
  } else {
    constexpr int smem = dq_simt_smem<D>();
    err = set_smem(flash_bwd_dq_simt_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_simt_kernel<D>
        <<<dim3((s.Sq + Geo<D>::BR - 1) / Geo<D>::BR, s.Hq, s.B),
           SIMT_THREADS, smem, stream>>>(
            q_, k_, v_, do_, in.lse, in.delta, ba, static_cast<T*>(dq_out),
            s.Sq, s.Sk, s.Hq, s.Hk, s.causal, s.scale);
  }
  return cudaGetLastError();
}

// shape checks shared by the entries: 0 = launch, -1 = nothing to do,
// else the error to return. Causal takes any Sq and Sk (top-left).
int check_shape(const Shape& s, int D, const BiasArgs& ba) {
  if (s.B <= 0 || s.Sq <= 0 || s.Sk <= 0) return -1;
  if (s.Hk <= 0 || s.Hq % s.Hk != 0 || (D != 64 && D != 128) ||
      ba.kind < kBiasAlibi || ba.kind > kBiasDense || ba.p == nullptr ||
      ba.R < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// one launch at D = 64 or 128 after the shape checks: CALL(DD) names the
// launch expression
#define PTT_DISPATCH(CALL)                                                  \
  do {                                                                      \
    const int c = check_shape(s, D, ba);                                    \
    if (c != 0) return c < 0 ? static_cast<int>(cudaSuccess) : c;           \
    return static_cast<int>(D == 64 ? CALL(64) : CALL(128));                \
  } while (0)

template <typename T>
int fwd_any(const void* q, const void* k, const void* v, const BiasArgs& ba,
            void* o, void* lse, const Shape& s, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define PTT_CALL(DD) fwd<T, DD>(q, k, v, ba, o, lse, s, st)
  PTT_DISPATCH(PTT_CALL);
#undef PTT_CALL
}

template <typename T>
int dkv_any(const BwdIn& in, const BiasArgs& ba, void* dk, void* dv,
            const Shape& s, int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define PTT_CALL(DD) dkv<T, DD>(in, ba, dk, dv, s, st)
  PTT_DISPATCH(PTT_CALL);
#undef PTT_CALL
}

template <typename T>
int dq_any(const BwdIn& in, const BiasArgs& ba, void* dq_out, const Shape& s,
           int D, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define PTT_CALL(DD) dq<T, DD>(in, ba, dq_out, s, st)
  PTT_DISPATCH(PTT_CALL);
#undef PTT_CALL
}

#undef PTT_DISPATCH

}  // namespace

// ---- bias (flash_attention_biased): kind 1 alibi (slopes f32 [Hq]), 2
// rel_table (f32 [Hq, 2R + 1]), 3 dense (f32 read through the element
// strides s_b, s_h, s_q, s_k of [B, Hq, Sq, Sk], 0 where it broadcasts);
// kv_valid: uint8 [B, Sk] padding mask (0 = padding) or null; causal is
// top-left for any Sq and Sk ----

#define PTT_BIAS_ARGS                                                         \
  const void *bias, const void *kv_valid, int B, int Sq, int Sk, int Hq,      \
      int Hk, int D, int causal, int kind, int R, long long s_b,              \
      long long s_h, long long s_q, long long s_k, float scale, void *stream
#define PTT_BIAS_VALUE                                                        \
  BiasArgs{kind,   R,   static_cast<const float*>(bias),                      \
           static_cast<const unsigned char*>(kv_valid), s_b, s_h, s_q, s_k}

#define PTT_BIAS_ENTRIES(SUFFIX, T)                                           \
  extern "C" int ptt_flash_attention_bias_fwd_##SUFFIX(                       \
      const void* q, const void* k, const void* v, void* o, void* lse,        \
      PTT_BIAS_ARGS) {                                                        \
    if (kind == 0) return static_cast<int>(cudaErrorInvalidValue);            \
    return fwd_any<T>(q, k, v, PTT_BIAS_VALUE, o, lse,                        \
                      Shape{B, Sq, Sk, Hq, Hk, causal, scale}, D, stream);    \
  }                                                                           \
  extern "C" int ptt_flash_attention_bias_dkv_##SUFFIX(                       \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dk, void* dv,                 \
      PTT_BIAS_ARGS) {                                                        \
    if (kind == 0) return static_cast<int>(cudaErrorInvalidValue);            \
    return dkv_any<T>(BwdIn{q, k, v, dout, static_cast<const float*>(lse),    \
                            static_cast<const float*>(delta)},                \
                      PTT_BIAS_VALUE, dk, dv,                                 \
                      Shape{B, Sq, Sk, Hq, Hk, causal, scale}, D, stream);    \
  }                                                                           \
  extern "C" int ptt_flash_attention_bias_dq_##SUFFIX(                        \
      const void* q, const void* k, const void* v, const void* dout,          \
      const void* lse, const void* delta, void* dq, PTT_BIAS_ARGS) {          \
    if (kind == 0) return static_cast<int>(cudaErrorInvalidValue);            \
    return dq_any<T>(BwdIn{q, k, v, dout, static_cast<const float*>(lse),     \
                           static_cast<const float*>(delta)},                 \
                     PTT_BIAS_VALUE, dq,                                      \
                     Shape{B, Sq, Sk, Hq, Hk, causal, scale}, D, stream);     \
  }

PTT_BIAS_ENTRIES(bf16, bf16)
PTT_BIAS_ENTRIES(f32, float)

#undef PTT_BIAS_ENTRIES
#undef PTT_BIAS_VALUE
#undef PTT_BIAS_ARGS
