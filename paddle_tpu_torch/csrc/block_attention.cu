// Block attention with softmax statistics, the f32 route: the
// unnormalised (m, l, o) of q against one block of keys, with an optional
// boolean mask and an optional additive f32 bias. BSHD layout, one head
// count for q and kv, head dim 64 or 128, any sequence lengths. The bf16
// route runs the wgmma forward core in its block-stats mode
// (flash_wgmma.cu, block_stats_wgmma_kernel).
//
// Replaces: paddle_tpu/kernels/block_attention.py::block_attention_stats
//   -> _pallas_fwd (the pallas_call at l.138): the per-chunk compute of
//   flash_attention_biased (kernels/flash_attention.py:215) and the
//   per-round compute of ring attention.
// Semantics (the reference's): s = (q k^T) * scale + bias in f32; an entry
//   is valid where mask is true and bias > -5e29; invalid entries take
//   s = -1e30 and p = 0 exactly; m = max(-1e30, max s), l = sum p,
//   o = sum p v. A fully masked row gives (-1e30, 0, 0); a -inf bias is
//   one more masked entry (no NaN: -inf is selected away before any
//   subtraction). m, l [B, H, Sq] f32; o [B, Sq, H, D] f32.
// Bound on the H100: operations at f32's 67 TFLOP/s outside the tensor
//   cores where the bias is narrow (sdpa's bias route at BERT width: 12.9
//   GFLOP of products against 101 MB), bytes where a full bias is read.
// Design (the first design, kept for f32): a block owns one (q tile,
//   head, batch) and loops over 64-key tiles with the f32 score tile in
//   shared memory (SIMT products); the bias is read in place through four
//   element strides (batch, head, q, k), so a bias broadcast over heads,
//   batch or queries (stride 0) is never materialised; the mask is read
//   from rows of mask_ld bytes.

#include "attention_tiles.cuh"

namespace {

using namespace ptt::attn;

constexpr float kNeg = -1e30f;       // the reference's _NEG
constexpr float kMaskedBias = -5e29f;  // bias at or below: masked

struct Bias {
  const float* p;                    // nullptr: no bias
  long long sb, sh, sq, sk;          // element strides
};

__device__ __forceinline__ bool entry(float& x, const unsigned char* mask,
                                      int mask_ld, const Bias& bias, int b,
                                      int h, int qi, int kj, int Sq, int Sk) {
  if (qi >= Sq || kj >= Sk) return false;
  if (mask != nullptr && !mask[static_cast<size_t>(qi) * mask_ld + kj])
    return false;
  if (bias.p != nullptr) {
    const float bv = bias.p[b * bias.sb + h * bias.sh + qi * bias.sq +
                            kj * bias.sk];
    if (!(bv > kMaskedBias)) return false;
    x += bv;
  }
  return true;
}

template <int D>
constexpr int stats_simt_smem() {
  using G = Geo<D>;
  return align128(G::BR * G::LDT * 4) + 2 * align128(G::BC * G::LDT * 4) +
         align128(G::BR * G::LDS * 4) * 2 + align128(G::BR * G::LDO * 4) +
         3 * align128(G::BR * 4) + align128(G::BR * G::LDS);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
block_stats_simt_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const unsigned char* __restrict__ mask,
                        int mask_ld, Bias bias, float* __restrict__ m_out,
                        float* __restrict__ l_out, float* __restrict__ o_out,
                        int Sq, int Sk, int H, float scale) {
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
  unsigned char* ok_s = cv.p;        // [BR][LDS] validity flags

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  load_rows<BR, D>(Qs, G::LDT, q, b, h, q0, Sq, H);
  for (int e = threadIdx.x; e < BR * G::LDO; e += blockDim.x) Os[e] = 0.f;
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }
  for (int k0 = 0; k0 < Sk; k0 += BC) {
    __syncthreads();                 // the last tile's K, V, P are free
    load_rows<BC, D>(Ks, G::LDT, k, b, h, k0, Sk, H);
    load_rows<BC, D>(Vs, G::LDT, v, b, h, k0, Sk, H);
    __syncthreads();
    tile_mm<false, true, BR, BC, D>(Ss, G::LDS, Qs, G::LDT, Ks, G::LDT,
                                    false);
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BR; r += nwarps) {
      float mx = kNeg;
      for (int c = lane; c < BC; c += 32) {
        float x = Ss[r * G::LDS + c] * scale;
        const bool ok = entry(x, mask, mask_ld, bias, b, h, q0 + r, k0 + c,
                              Sq, Sk);
        ok_s[r * G::LDS + c] = ok;
        x = ok ? x : kNeg;
        Ss[r * G::LDS + c] = x;
        mx = fmaxf(mx, x);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BC; c += 32) {
        const float p = ok_s[r * G::LDS + c]
                            ? expf(Ss[r * G::LDS + c] - m_new) : 0.f;
        Ps[r * G::LDS + c] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
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
    if (s < Sq)
      o_out[((static_cast<size_t>(b) * Sq + s) * H + h) * D + c] =
          Os[r * G::LDO + c];
  }
  for (int r = threadIdx.x; r < BR; r += blockDim.x)
    if (q0 + r < Sq) {
      const size_t st = (static_cast<size_t>(b) * H + h) * Sq + q0 + r;
      m_out[st] = m_s[r];
      l_out[st] = l_s[r];
    }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const unsigned char* mask, int mask_ld,
                       const Bias& bias, float* m, float* l, float* o, int B,
                       int Sq, int Sk, int H, float scale,
                       cudaStream_t stream) {
  constexpr int smem = stats_simt_smem<D>();
  cudaError_t err = set_smem(block_stats_simt_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  block_stats_simt_kernel<D>
      <<<dim3((Sq + Geo<D>::BR - 1) / Geo<D>::BR, H, B), SIMT_THREADS, smem,
         stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), mask, mask_ld, bias, m, l, o,
                   Sq, Sk, H, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, H, D] f32; mask uint8 rows of mask_ld bytes
// (>= Sk) or null; bias f32 read at bias[b sb + h sh + i sq + j sk], or
// null; m, l [B, H, Sq] and o [B, Sq, H, D] f32 out. The bf16 entry is
// flash_wgmma.cu's.
extern "C" int ptt_block_attention_fwd_f32(
    const void* q, const void* k, const void* v, const void* mask,
    const void* bias, void* m, void* l, void* o, int B, int Sq, int Sk, int H,
    int D, int mask_ld, long long sb, long long sh, long long sq,
    long long sk, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (Sk <= 0 || (D != 64 && D != 128) ||
      (mask != nullptr && mask_ld < Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Bias bs{static_cast<const float*>(bias), sb, sh, sq, sk};
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* mo = static_cast<float*>(m);
  auto* lo = static_cast<float*>(l);
  auto* oo = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      D == 64 ? launch_f32<64>(q, k, v, mk, mask_ld, bs, mo, lo, oo, B, Sq,
                               Sk, H, scale, st)
              : launch_f32<128>(q, k, v, mk, mask_ld, bs, mo, lo, oo, B, Sq,
                                Sk, H, scale, st);
  return static_cast<int>(err);
}
