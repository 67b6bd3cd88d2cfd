// Paged decode attention: one query token per sequence attends to the
// first lengths[b] tokens of its KV, read through the block table
// page_indices[b, j / page] from a page pool [kvh, n_pages, page, d]
// with arbitrary outer strides (head, page, token in page) and unit
// stride along d. GQA: kv head kh serves q heads kh*rep .. kh*rep+rep-1.
//
// Replaces: paddle_tpu/kernels/paged_attention.py::paged_decode_attention
//   (l.78: jax.experimental.pallas.ops.tpu.paged_attention, whose grid
//   walked (kv head, sequence, page block) with the page gather in a
//   scalar-prefetch index map).
// Bound on the H100: bytes — each live K and V row is read once (4 flops
//   per bf16 K/V byte pair at one query row: far below the 295 flops a
//   byte the tensor cores would need), plus q and out once.
// Design: one block per (kv head, group of <= G q heads, sequence), so a
//   K/V row is read once for every q head it serves. The block stages the
//   sequence's page ids in shared memory, then its 8 warps walk the keys:
//   a key row is read as 16-byte vectors by D*sizeof(T)/16 lanes (16 for
//   bf16 at d = 128), so one warp reads 32*16/(D*sizeof(T)) keys at once,
//   and each lane issues UNROLL keys' K and V loads before it uses any,
//   keeping several hundred bytes per lane in flight. A key's score is
//   its lanes' partial dot reduced by shuffles; each lane group keeps its
//   own online softmax (m, l, acc) in f32 per q head, and the groups are
//   merged by shuffles within a warp, then across warps in shared memory.
//   Tensor cores are not used: at one query row the work is a GEMV.
//   q is pre-scaled in q's own dtype before the f32 math (the reference's
//   float order, which greedy ties depend on). A sequence of length 0
//   returns zeros (the reference's fallback returns NaN there; no caller
//   passes 0). Lengths past the block table are cut to it, as the
//   fallback's mask does. Requires d in {64, 128}, nh % kvh == 0.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;     // keys in flight per lane group

// T: element type; D: head dim; G: q heads per block (>= the heads this
// block serves, nq).
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, T* __restrict__ out,
                    int nh, int kvh, int page, int ppseq, long long s_head,
                    long long s_page, long long s_tok, float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int LPK = D / VEC;            // lanes per key row
  constexpr int KPW = 32 / LPK;           // keys a warp reads at once
  constexpr int STRIDE = WARPS * KPW;     // keys the block reads at once
  __shared__ float s_m[WARPS][G];
  __shared__ float s_l[WARPS][G];
  __shared__ __align__(16) float s_acc[WARPS][G][D];
  extern __shared__ int s_pages[];        // [ppseq] this sequence's pages

  const int b = blockIdx.y;
  const int kh = blockIdx.x % kvh;
  const int chunk = blockIdx.x / kvh;
  const int rep = nh / kvh;
  const int h0 = kh * rep + chunk * G;    // first q head of this block
  const int nq = min(G, rep - chunk * G);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;             // which key of the warp's KPW
  const int sl = lane % LPK;              // which vector of the key row
  const int len = max(0, min(lengths[b], ppseq * page));

  const int n_used = (len + page - 1) / page;
  for (int i = threadIdx.x; i < n_used; i += THREADS)
    s_pages[i] = page_indices[static_cast<size_t>(b) * ppseq + i];

  // this lane's slice of each q head, pre-scaled and rounded in T
  float qr[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < nq) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * nh + h0 + g) * D + sl * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qr[g][i] = ptt::to_f(ptt::from_f<T>(ptt::to_f(e[i]) * scale));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
    }
  }
  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();                        // s_pages is staged

  const T* kbase = k_pages + kh * s_head + sl * VEC;
  const T* vbase = v_pages + kh * s_head + sl * VEC;
  for (int j0 = 0; j0 < len; j0 += STRIDE * UNROLL) {
    uint4 kv[UNROLL], vv[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * STRIDE + warp * KPW + sub;
      ok[u] = j < len;
      if (ok[u]) {
        const long long off = s_pages[j / page] * s_page + (j % page) * s_tok;
        kv[u] = *reinterpret_cast<const uint4*>(kbase + off);
        vv[u] = *reinterpret_cast<const uint4*>(vbase + off);
      } else {
        kv[u] = make_uint4(0u, 0u, 0u, 0u);
        vv[u] = kv[u];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* ke = reinterpret_cast<const T*>(&kv[u]);
      const T* ve = reinterpret_cast<const T*>(&vv[u]);
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          part = fmaf(qr[g][i], ptt::to_f(ke[i]), part);
        // every lane shuffles (a key's lanes are one aligned group of LPK)
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[g] = part;
      }
      if (ok[u]) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);   // 0 while m is -inf
          const float p = expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            acc[g][i] = fmaf(p, ptt::to_f(ve[i]), acc[g][i] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warp's KPW lane groups (lanes holding the same d-slice)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = m[g] == -INFINITY ? 0.f : expf(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) s_acc[warp][g][sl * VEC + i] = acc[g][i];
      if (sl == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; one output element per thread and step
  for (int idx = threadIdx.x; idx < nq * D; idx += THREADS) {
    const int g = idx / D;
    const int dd = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float c = s_m[w][g] == -INFINITY ? 0.f : expf(s_m[w][g] - mx);
        lsum += s_l[w][g] * c;
        o += s_acc[w][g][dd] * c;
      }
    }
    out[(static_cast<size_t>(b) * nh + h0 + g) * D + dd] =
        ptt::from_f<T>(lsum > 0.f ? o / lsum : 0.f);
  }
}

template <typename T, int D, int G>
int launch_g(const void* q, const void* kp, const void* vp, const int* lens,
             const int* pidx, void* out, int B, int nh, int kvh, int page,
             int ppseq, long long s_head, long long s_page, long long s_tok,
             float scale, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, D, G>;
  const size_t static_smem =
      sizeof(float) * WARPS * G * (D + 2);
  const size_t dyn = sizeof(int) * static_cast<size_t>(ppseq);
  if (static_smem + dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rep = nh / kvh;
  dim3 grid(kvh * ((rep + G - 1) / G), B);
  kern<<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lens, pidx, static_cast<T*>(out), nh, kvh,
      page, ppseq, s_head, s_page, s_tok, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* q, const void* kp, const void* vp, const int* lens,
             const int* pidx, void* out, int B, int nh, int kvh, int page,
             int ppseq, long long s_head, long long s_page, long long s_tok,
             float scale, cudaStream_t st) {
  const int rep = nh / kvh;
  if (rep <= 1)
    return launch_g<T, D, 1>(q, kp, vp, lens, pidx, out, B, nh, kvh, page,
                             ppseq, s_head, s_page, s_tok, scale, st);
  if (rep <= 2)
    return launch_g<T, D, 2>(q, kp, vp, lens, pidx, out, B, nh, kvh, page,
                             ppseq, s_head, s_page, s_tok, scale, st);
  if (rep <= 4)
    return launch_g<T, D, 4>(q, kp, vp, lens, pidx, out, B, nh, kvh, page,
                             ppseq, s_head, s_page, s_tok, scale, st);
  return launch_g<T, D, 8>(q, kp, vp, lens, pidx, out, B, nh, kvh, page,
                           ppseq, s_head, s_page, s_tok, scale, st);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* lens,
           const void* pidx, void* out, int B, int nh, int kvh, int page,
           int ppseq, int d, long long s_head, long long s_page,
           long long s_tok, float scale, void* stream) {
  if (kvh <= 0 || nh % kvh != 0 || page <= 0 || ppseq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  if (d == 64)
    return launch_d<T, 64>(q, kp, vp, i32(lens), i32(pidx), out, B, nh, kvh,
                           page, ppseq, s_head, s_page, s_tok, scale, st);
  if (d == 128)
    return launch_d<T, 128>(q, kp, vp, i32(lens), i32(pidx), out, B, nh, kvh,
                            page, ppseq, s_head, s_page, s_tok, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ptt_paged_decode_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* lengths,
    const void* page_indices, void* out, int B, int nh, int kvh, int page,
    int ppseq, int d, long long s_head, long long s_page, long long s_tok,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, lengths, page_indices, out, B, nh,
                               kvh, page, ppseq, d, s_head, s_page, s_tok,
                               scale, stream);
}

extern "C" int ptt_paged_decode_attention_f32(
    const void* q, const void* kp, const void* vp, const void* lengths,
    const void* page_indices, void* out, int B, int nh, int kvh, int page,
    int ppseq, int d, long long s_head, long long s_page, long long s_tok,
    float scale, void* stream) {
  return launch<float>(q, kp, vp, lengths, page_indices, out, B, nh, kvh,
                       page, ppseq, d, s_head, s_page, s_tok, scale, stream);
}
