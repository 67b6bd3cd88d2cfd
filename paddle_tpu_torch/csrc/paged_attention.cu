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
// Design: split-KV. The grid is (kv head x group of <= G q heads,
//   sequence, split): a split is a fixed run of `split_pages` pages, and
//   the split count is bounded on the host from the block table's width,
//   so the grid is static; blocks past a sequence's length exit. A K/V
//   row is read once for every q head it serves (the group's heads share
//   the block). Each block stages its split's page ids in shared memory,
//   then its 8 warps walk the split's keys (paged_split.cuh::walk_split:
//   lanes over d with 16-byte loads, several keys in flight per lane,
//   online softmax (m, l, acc) in f32 per q head). A sequence with one
//   split writes its output directly; otherwise each split writes its
//   partial (m, l, o) to the wrapper's scratch and the last block to
//   arrive (an atomic ticket) merges the splits in split order
//   (paged_split.cuh::merge_rows): bitwise repeatable, no float atomics.
//   The first design ran one block per (kv head, group, sequence): at
//   llama_7b's batch of 4 that was 128 blocks on 132 SMs, and the kernel
//   lasted as long as the 700-token sequence's serial walk while the
//   short sequences' SMs idled. Split size: SPLIT_KEYS (256 keys,
//   kernels/_paged_split.py, shared with the ragged kernel), from chip_smoke.py's sweep on
//   the H100 (PERF.md, PR 13): at the bucketed engine's case 128 and 256
//   read alike, 64-key splits double the blocks (most of them past a
//   short sequence's length) and the merges, 512-key splits leave the
//   700-token walk on two blocks again; at generate's 129-191-key caches
//   128-key splits cost each sequence a merge that the shorter walk does
//   not repay. The page ids of a block's split are staged before its
//   length is read, so the two loads overlap.
//   Tensor cores are not used: at one query row the work is a GEMV.
//   q is pre-scaled in q's own dtype before the f32 math (the reference's
//   float order, which greedy ties depend on). A sequence of length 0
//   returns zeros (the reference's fallback returns NaN there; no caller
//   passes 0). Lengths past the block table are cut to it, as the
//   fallback's mask does. Requires d in {64, 128}, nh % kvh == 0.

#include <math.h>

#include "common.cuh"
#include "paged_split.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;     // keys in flight per lane group

// T: element type; D: head dim; G: q heads per block (>= the heads this
// block serves, nq). part_o [n_split][B * nh][D] and part_ml
// [n_split][B * nh] are the splits' partials; tickets [B][gridDim.x].
template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, T* __restrict__ out,
                    float* part_o, float2* part_ml, int* tickets, int nh,
                    int kvh, int page, int ppseq, int split_pages,
                    long long s_head, long long s_page, long long s_tok,
                    float scale) {
  namespace pg = ptt::paged;
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int LPK = D / VEC;            // lanes per key row
  __shared__ float s_m[WARPS][G];
  __shared__ float s_l[WARPS][G];
  __shared__ __align__(16) float s_acc[WARPS][G][D];
  __shared__ float res_m[G], res_l[G];
  __shared__ int s_rows[G];
  __shared__ float2 s_ml[pg::MAX_SPLITS * G];
  extern __shared__ int s_pages[];        // [split_pages] this split's pages

  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int kh = blockIdx.x % kvh;
  const int chunk = blockIdx.x / kvh;
  const int rep = nh / kvh;
  const int h0 = kh * rep + chunk * G;    // first q head of this block
  const int nq = min(G, rep - chunk * G);
  const int sl = (threadIdx.x % 32) % LPK;  // which vector of the key row
  // the split's pages in the table are staged before the length is
  // known, so the two loads overlap
  int k0, k1;
  pg::split_range(z, split_pages, page, ppseq * page, k0, k1);
  pg::stage_pages(s_pages, page_indices + static_cast<size_t>(b) * ppseq,
                  k0, k1, page);
  const int len = max(0, min(lengths[b], ppseq * page));
  const int n_live = pg::live_splits(len, split_pages * page);
  if (z >= n_live) return;                // uniform: past the length
  k1 = min(k1, len);
  if (threadIdx.x < G)
    s_rows[threadIdx.x] = static_cast<int>(threadIdx.x) < nq
                              ? b * nh + h0 + static_cast<int>(threadIdx.x)
                              : -1;

  // this lane's slice of each q head, pre-scaled and rounded in T
  float qr[G][VEC];
  int nvis[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    nvis[g] = len;
    if (g < nq) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * nh + h0 + g) * D + sl * VEC);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qr[g][i] = ptt::to_f(ptt::from_f<T>(ptt::to_f(e[i]) * scale)) *
                   pg::LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qr[g][i] = 0.f;
    }
  }
  __syncthreads();                        // s_pages, s_rows are staged

  pg::walk_split<T, D, G, WARPS, UNROLL>(
      qr, nvis, k0, k1, s_pages, page, k_pages + kh * s_head + sl * VEC,
      v_pages + kh * s_head + sl * VEC, s_page, s_tok, &s_m[0][0],
      &s_l[0][0], &s_acc[0][0][0]);
  __syncthreads();
  pg::combine_warps<G, D, WARPS>(&s_m[0][0], &s_l[0][0], &s_acc[0][0][0],
                                 nq, res_m, res_l);
  __syncthreads();
  pg::finish_split<T, D, G, THREADS>(
      s_rows, nq, res_m, res_l, &s_acc[0][0][0], z, n_live, gridDim.y * nh,
      part_o, part_ml,
      tickets + static_cast<size_t>(b) * gridDim.x + blockIdx.x, out, s_ml,
      G);
}

template <typename T, int D, int G>
int launch_g(const void* q, const void* kp, const void* vp, const int* lens,
             const int* pidx, void* out, void* part, int* tickets, int B,
             int nh, int kvh, int page, int ppseq, int split_pages,
             long long s_head, long long s_page, long long s_tok,
             float scale, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, D, G>;
  const size_t static_smem =
      sizeof(float) * (WARPS * G * (D + 2) + 2 * G +
                       2 * ptt::paged::MAX_SPLITS * G) + sizeof(int) * G;
  const size_t dyn = sizeof(int) * static_cast<size_t>(split_pages);
  if (static_smem + dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rep = nh / kvh;
  const int n_split = (ppseq + split_pages - 1) / split_pages;
  auto* part_ml = static_cast<float2*>(part);
  float* part_o = part == nullptr
                      ? nullptr
                      : static_cast<float*>(part) +
                            ptt::paged::part_o_offset(n_split, B * nh);
  dim3 grid(kvh * ((rep + G - 1) / G), B, n_split);
  kern<<<grid, THREADS, dyn, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), lens, pidx, static_cast<T*>(out), part_o,
      part_ml, tickets, nh, kvh, page, ppseq, split_pages, s_head, s_page,
      s_tok, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(const void* q, const void* kp, const void* vp, const int* lens,
             const int* pidx, void* out, void* part, int* tickets, int B,
             int nh, int kvh, int page, int ppseq, int split_pages,
             long long s_head, long long s_page, long long s_tok,
             float scale, cudaStream_t st) {
  const int rep = nh / kvh;
  if (rep <= 1)
    return launch_g<T, D, 1>(q, kp, vp, lens, pidx, out, part, tickets, B,
                             nh, kvh, page, ppseq, split_pages, s_head,
                             s_page, s_tok, scale, st);
  if (rep <= 2)
    return launch_g<T, D, 2>(q, kp, vp, lens, pidx, out, part, tickets, B,
                             nh, kvh, page, ppseq, split_pages, s_head,
                             s_page, s_tok, scale, st);
  if (rep <= 4)
    return launch_g<T, D, 4>(q, kp, vp, lens, pidx, out, part, tickets, B,
                             nh, kvh, page, ppseq, split_pages, s_head,
                             s_page, s_tok, scale, st);
  return launch_g<T, D, 8>(q, kp, vp, lens, pidx, out, part, tickets, B, nh,
                           kvh, page, ppseq, split_pages, s_head, s_page,
                           s_tok, scale, st);
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* lens,
           const void* pidx, void* out, void* part, void* tickets, int B,
           int nh, int kvh, int page, int ppseq, int split_pages, int d,
           long long s_head, long long s_page, long long s_tok, float scale,
           void* stream) {
  if (kvh <= 0 || nh % kvh != 0 || page <= 0 || ppseq <= 0 ||
      split_pages <= 0 ||
      (ppseq + split_pages - 1) / split_pages > ptt::paged::MAX_SPLITS ||
      (part == nullptr && split_pages < ppseq))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  auto* tk = static_cast<int*>(tickets);
  if (d == 64)
    return launch_d<T, 64>(q, kp, vp, i32(lens), i32(pidx), out, part, tk, B,
                           nh, kvh, page, ppseq, split_pages, s_head, s_page,
                           s_tok, scale, st);
  if (d == 128)
    return launch_d<T, 128>(q, kp, vp, i32(lens), i32(pidx), out, part, tk,
                            B, nh, kvh, page, ppseq, split_pages, s_head,
                            s_page, s_tok, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ptt_paged_decode_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* lengths,
    const void* page_indices, void* out, void* part, void* tickets, int B,
    int nh, int kvh, int page, int ppseq, int split_pages, int d,
    long long s_head, long long s_page, long long s_tok, float scale,
    void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, lengths, page_indices, out, part,
                               tickets, B, nh, kvh, page, ppseq, split_pages,
                               d, s_head, s_page, s_tok, scale, stream);
}

extern "C" int ptt_paged_decode_attention_f32(
    const void* q, const void* kp, const void* vp, const void* lengths,
    const void* page_indices, void* out, void* part, void* tickets, int B,
    int nh, int kvh, int page, int ppseq, int split_pages, int d,
    long long s_head, long long s_page, long long s_tok, float scale,
    void* stream) {
  return launch<float>(q, kp, vp, lengths, page_indices, out, part, tickets,
                       B, nh, kvh, page, ppseq, split_pages, d, s_head,
                       s_page, s_tok, scale, stream);
}
