// Ragged paged attention: packed prefill-chunk and decode rows of every
// sequence attend causally, in ONE launch, to their KV held in the
// shared page pool [kvh, n_pages, page, d] through a per-sequence block
// table. Row t of sequence s sits at absolute position
// kv_len[s] - q_len[s] + (t - q_start[s]); GQA reads KV head h / rep.
//
// Replaces: paddle_tpu/kernels/ragged_paged_attention.py::
//   ragged_paged_attention (_pallas_path -> kern, whose grid walked
//   (seq, head, q_block, kv_page) with the page gather in a scalar-
//   prefetch index map).
// Bound on the H100: bytes — the KV pages read (a decode row does 4
//   flops per KV byte in bf16), plus q and out once.
// Design: one block per (q block of <= 16 rows, q head, sequence). Rows
//   are read in place at q_start[s] (no repack). A loop inside the
//   block walks the sequence's pages, reading page ids from page_table
//   itself (this replaces scalar prefetch and the sequential kv grid
//   axis), and stops at the last page the block's causal limit
//   kv_len - q_len + last_row reaches. Pages are gathered 64 keys at a
//   time into shared memory by cp.async, double-buffered so the next
//   tile's pages are in flight while this tile is consumed. A block's
//   time is its rows' serial walk over the keys, so the walk is kept
//   short: a prefill block gives each of its 16 rows 8 threads (each
//   holding an interleaved eighth of q and of the f32 accumulator in
//   registers, combined by 3 shuffles), and a block of <= 4 rows
//   (decode) gives each row a full warp. A deep prefill chunk spreads
//   over several blocks that walk its keys in parallel (the first
//   version's 64-row blocks with 2 threads a row ran 64-deep dot
//   products and left one block per head to walk a 700-key context
//   alone). Online softmax (m, l, acc) in f32, 16 keys per rescale. q is
//   pre-scaled in q's own dtype before the f32 math (the reference
//   fallback's float order, which greedy ties depend on). Blocks past a
//   sequence's q_len exit at once; the wrapper zero-fills the output, so
//   rows of idle slots and rows that belong to no sequence come back
//   zero. Requires page in {8, 16, 32, 64}.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 16;      // query rows per block
constexpr int THREADS = 128;
constexpr int KT = 64;        // keys per shared-memory tile (whole pages)
constexpr int KCHUNK = 16;    // keys per online-softmax rescale

// Attend the block's rows_here query rows with TPR threads per row
// (each owning D / TPR interleaved dims of q and of the accumulator).
// TPR = 8 carries a 16-row prefill block; TPR = 32 carries decode rows
// (rows_here <= 4).
template <typename T, int D, int TPR>
__device__ __forceinline__ void attend(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    T* __restrict__ out, T* Kbuf, T* Vbuf, int s, int h, int kh, int nh,
    int n_pages, int page, int ppmax, int qs, int row0, int rows_here,
    int ctx, int klen, int n_visit, float scale) {
  constexpr int DH = D / TPR;
  const int tid = threadIdx.x;
  const int lane = tid % TPR;
  const int lr = tid / TPR;
  const bool row_ok = lr < rows_here;
  const int local = row0 + lr;
  const int pos = ctx + local;

  float qr[DH], acc[DH];
  if (row_ok) {
    const T* qrow = q + (static_cast<size_t>(qs + local) * nh + h) * D;
#pragma unroll
    for (int i = 0; i < DH; ++i)
      qr[i] = ptt::to_f(
          ptt::from_f<T>(ptt::to_f(qrow[i * TPR + lane]) * scale));
  } else {
#pragma unroll
    for (int i = 0; i < DH; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  const int ppt = KT / page;                 // pages per tile
  const int n_tiles = (n_visit + ppt - 1) / ppt;
  const int vec_per_page = page * D * static_cast<int>(sizeof(T)) / 16;

  // gather tile t's pages (through page_table) into buffer t & 1
  auto load_tile = [&](int t) {
    T* kd = Kbuf + (t & 1) * KT * D;
    T* vd = Vbuf + (t & 1) * KT * D;
    for (int v = tid; v < ppt * vec_per_page; v += THREADS) {
      const int pi = v / vec_per_page;
      const int p = t * ppt + pi;
      if (p < n_visit) {
        const int off = v % vec_per_page;
        const int pid = page_table[s * ppmax + p];
        const size_t page_off =
            (static_cast<size_t>(kh) * n_pages + pid) * page * D;
        ptt::cp_async16(
            reinterpret_cast<uint4*>(kd + pi * page * D) + off,
            reinterpret_cast<const uint4*>(k_pages + page_off) + off);
        ptt::cp_async16(
            reinterpret_cast<uint4*>(vd + pi * page * D) + off,
            reinterpret_cast<const uint4*>(v_pages + page_off) + off);
      }
    }
  };

  load_tile(0);
  ptt::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);   // the other buffer is free
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();                 // tile t has landed
    __syncthreads();
    const T* Ks = Kbuf + (t & 1) * KT * D;
    const T* Vs = Vbuf + (t & 1) * KT * D;
    const int base = t * KT;
    const int nkeys = min(KT, n_visit * page - base);
    for (int j0 = 0; j0 < nkeys; j0 += KCHUNK) {
      float sc[KCHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < KCHUNK; ++j) {
        const int jj = j0 + j;
        float part = 0.f;
        if (jj < nkeys) {                    // uniform across the block
          const T* kr = Ks + jj * D + lane;
#pragma unroll
          for (int i = 0; i < DH; ++i)
            part = fmaf(qr[i], ptt::to_f(kr[i * TPR]), part);
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kpos = base + jj;
        const bool valid =
            row_ok && jj < nkeys && kpos <= pos && kpos < klen;
        sc[j] = valid ? part : -INFINITY;
        cmax = fmaxf(cmax, sc[j]);
      }
      if (cmax != -INFINITY) {
        const float m_new = fmaxf(m, cmax);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int i = 0; i < DH; ++i) acc[i] *= alpha;
#pragma unroll
        for (int j = 0; j < KCHUNK; ++j) {
          if (sc[j] != -INFINITY) {
            const float pj = expf(sc[j] - m_new);
            l += pj;
            const T* vr = Vs + (j0 + j) * D + lane;
#pragma unroll
            for (int i = 0; i < DH; ++i)
              acc[i] = fmaf(pj, ptt::to_f(vr[i * TPR]), acc[i]);
          }
        }
        m = m_new;
      }
    }
    __syncthreads();                         // buffer t & 1 free again
  }
  ptt::cp_async_wait<0>();

  if (row_ok) {
    T* orow = out + (static_cast<size_t>(qs + local) * nh + h) * D;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < DH; ++i)
      orow[i * TPR + lane] = ptt::from_f<T>(l > 0.f ? acc[i] * inv : 0.f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ q_start,
                              const int* __restrict__ q_len,
                              const int* __restrict__ kv_len,
                              const int* __restrict__ page_table,
                              T* __restrict__ out, int nh, int kvh,
                              int n_pages, int page, int ppmax, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Kbuf = reinterpret_cast<T*>(smem_raw);  // [2][KT * D]
  T* Vbuf = Kbuf + 2 * KT * D;               // [2][KT * D]

  const int s = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int qlen = q_len[s];
  if (row0 >= qlen) return;                  // uniform: no rows here
  const int klen = kv_len[s];
  const int qs = q_start[s];
  const int ctx = klen - qlen;               // position of local row 0
  const int rows_here = min(ROWS, qlen - row0);
  const int last_pos = ctx + row0 + rows_here - 1;
  if (last_pos < 0) return;
  const int n_visit = min(last_pos / page + 1, ppmax);
  const int kh = h / (nh / kvh);
  if (rows_here <= THREADS / 32)
    attend<T, D, 32>(q, k_pages, v_pages, page_table, out, Kbuf, Vbuf, s, h,
                     kh, nh, n_pages, page, ppmax, qs, row0, rows_here, ctx,
                     klen, n_visit, scale);
  else
    attend<T, D, 8>(q, k_pages, v_pages, page_table, out, Kbuf, Vbuf, s, h,
                    kh, nh, n_pages, page, ppmax, qs, row0, rows_here, ctx,
                    klen, n_visit, scale);
}

template <typename T, int D>
int launch_d(const void* q, const void* kp, const void* vp, const int* qs,
             const int* ql, const int* kl, const int* pt, void* out, int T_,
             int nh, int kvh, int n_pages, int page, int B, int ppmax,
             float scale, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(KT) * D * sizeof(T);
  auto kern = ragged_paged_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((T_ + ROWS - 1) / ROWS, nh, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), qs, ql, kl, pt, static_cast<T*>(out), nh,
      kvh, n_pages, page, ppmax, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* qs,
           const void* ql, const void* kl, const void* pt, void* out, int T_,
           int nh, int kvh, int n_pages, int page, int d, int B, int ppmax,
           float scale, void* stream) {
  if (T_ <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  auto st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  if (d == 64)
    return launch_d<T, 64>(q, kp, vp, i32(qs), i32(ql), i32(kl), i32(pt), out,
                           T_, nh, kvh, n_pages, page, B, ppmax, scale, st);
  if (d == 128)
    return launch_d<T, 128>(q, kp, vp, i32(qs), i32(ql), i32(kl), i32(pt),
                            out, T_, nh, kvh, n_pages, page, B, ppmax, scale,
                            st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int ptt_ragged_paged_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* q_start,
    const void* q_len, const void* kv_len, const void* page_table, void* out,
    int T, int nh, int kvh, int n_pages, int page, int d, int B, int ppmax,
    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, kp, vp, q_start, q_len, kv_len, page_table,
                               out, T, nh, kvh, n_pages, page, d, B, ppmax,
                               scale, stream);
}

extern "C" int ptt_ragged_paged_attention_f32(
    const void* q, const void* kp, const void* vp, const void* q_start,
    const void* q_len, const void* kv_len, const void* page_table, void* out,
    int T, int nh, int kvh, int n_pages, int page, int d, int B, int ppmax,
    float scale, void* stream) {
  return launch<float>(q, kp, vp, q_start, q_len, kv_len, page_table, out, T,
                       nh, kvh, n_pages, page, d, B, ppmax, scale, stream);
}
