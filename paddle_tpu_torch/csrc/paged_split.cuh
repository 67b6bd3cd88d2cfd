// Split-KV pieces shared by the paged attention kernels
// (paged_attention.cu, ragged_paged_attention.cu): the split schedule,
// the decode walk over one split's keys, and the exact merge of the
// splits' partials.
//
// A row's keys [0, kend) are cut into splits of sk = split_pages * page
// keys; split z covers [z * sk, min(z * sk + sk, kend)), and a row group
// with kend keys has ceil(kend / sk) live splits (at least one).
// Each split is one block's work. A group with one live split writes its
// output directly; otherwise each split writes its partial (m, l, o) in
// f32 (m in the log2 domain: scores carry a factor log2(e), so every
// exponential is one exp2), o unnormalised, to scratch [split][row][...]
// that the wrapper
// allocates, and takes a ticket: the block that arrives last merges the
// group's splits in split order, reading every partial back from the
// scratch (its own too), so the result does not depend on which block
// was last and is bitwise repeatable. No float atomics. The last block
// resets the ticket to zero for the next launch on the stream.
#pragma once

#include <math.h>

#include "common.cuh"

namespace ptt {
namespace paged {

// most live splits of one row group (the wrappers size splits to it)
constexpr int MAX_SPLITS = 32;
constexpr float LOG2E = 1.4426950408889634f;

// key j's page index within a run starting at a page boundary, and its
// token in the page: shifts where the page is a power of two
struct PageOf {
  int page, shift;   // shift -1: divide
  __device__ explicit PageOf(int page_) : page(page_), shift(-1) {
    if ((page & (page - 1)) == 0)
      for (shift = 0; (1 << shift) < page; ++shift) {
      }
  }
  __device__ __forceinline__ int index(int rel) const {
    return shift >= 0 ? rel >> shift : rel / page;
  }
  __device__ __forceinline__ int token(int j) const {
    return shift >= 0 ? j & (page - 1) : j % page;
  }
};

// The wrapper's scratch for n_split splits of R rows of D: the partials'
// (m, l) [n_split][R] first, then o [n_split][R][D] from the next 16-byte
// boundary (the merge reads o as float4). Host and device agree on it.
__host__ __device__ inline size_t part_o_offset(int n_split, int R) {
  return (2 * static_cast<size_t>(n_split) * R + 3) / 4 * 4;
}

// keys [k0, k1) of split z, a run of split_pages pages, of a row group
// with kend keys
__device__ __forceinline__ void split_range(int z, int split_pages,
                                            int page, int kend, int& k0,
                                            int& k1) {
  k0 = z * split_pages * page;
  k1 = min(k0 + split_pages * page, kend);
}

__device__ __forceinline__ int live_splits(int kend, int sk) {
  return kend <= 0 ? 1 : (kend + sk - 1) / sk;
}

// Stage the page ids of keys [k0, k1) (k0 a page multiple): s_pages[i]
// holds page (k0 / page + i) of the sequence's block table row `table`.
__device__ __forceinline__ void stage_pages(int* s_pages,
                                            const int* __restrict__ table,
                                            int k0, int k1, int page) {
  const int p0 = k0 / page;
  const int p1 = (k1 + page - 1) / page;
  for (int i = p0 + static_cast<int>(threadIdx.x); i < p1;
       i += blockDim.x)
    s_pages[i - p0] = table[i];
}

// True in every thread of the block that arrives last of `n_live` at
// `ticket`, after this block's partials were written. Call with the whole
// block; the last one finds the others' partials through __ldcg.
__device__ __forceinline__ bool ticket_last(int* ticket, int n_live) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(ticket, 1);
    s_last = arrived == n_live - 1;
    if (s_last) atomicExch(ticket, 0);
  }
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  __syncthreads();                        // s_last may be reused
  return last;
}

// Merge the n_live splits' partials of `nrows` (<= MAXR) rows (rows[r]:
// the row's index in out [*, D] and in the scratch, or -1) in split
// order: out = sum_z w_z o_z with w_z = 2^(m_z - M) / L, L = sum_z l_z
// 2^(m_z - M); a row with no key in any split gets zeros. Every split's
// (m, l) is read at once into s_ml (MAX_SPLITS x wstride) and turned into
// its weight there; then each thread takes its float4s of the output a
// batch of up to 8 at a time and reads each split's share of the batch
// with all its loads in flight: the merge costs about 1 + n_live trips to
// L2 a batch. Call with the whole block of NT threads.
template <typename T, int D, int MAXR, int NT>
__device__ void merge_rows(const int* rows, int nrows, int n_live, int R,
                           const float* part_o, const float2* part_ml,
                           T* __restrict__ out, float2* s_ml, int wstride) {
  for (int e = threadIdx.x; e < n_live * nrows; e += NT) {
    const int z = e / nrows;
    const int r = e % nrows;
    const int row = rows[r];
    s_ml[z * wstride + r] =
        row < 0 ? make_float2(-INFINITY, 0.f)
                : __ldcg(&part_ml[static_cast<size_t>(z) * R + row]);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += NT) {
    float M = -INFINITY;
    for (int z = 0; z < n_live; ++z) M = fmaxf(M, s_ml[z * wstride + r].x);
    float L = 0.f;
    for (int z = 0; z < n_live; ++z) {
      const float2 ml = s_ml[z * wstride + r];
      if (ml.x != -INFINITY) L += ml.y * exp2f(ml.x - M);
    }
    for (int z = 0; z < n_live; ++z) {
      float2& ml = s_ml[z * wstride + r];
      ml.x = (ml.x == -INFINITY || L == 0.f) ? 0.f : exp2f(ml.x - M) / L;
    }
  }
  constexpr int C = D / 4;                       // float4s a row
  constexpr int PER = (MAXR * C + NT - 1) / NT;  // float4s a thread
  constexpr int BATCH = PER < 8 ? PER : 8;       // loads in flight a trip
  __syncthreads();                        // the weights are ready
  for (int k0 = 0; k0 < PER; k0 += BATCH) {
    int off[BATCH];                  // row * D + column of each, or -1
    float a[BATCH][4];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int f = (k0 + k) * NT + threadIdx.x;
      const int row = k0 + k < PER && f < nrows * C ? rows[f / C] : -1;
      off[k] = row < 0 ? -1 : row * D + (f % C) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) a[k][i] = 0.f;
    }
    for (int z = 0; z < n_live; ++z) {
      const float* pz = part_o + static_cast<size_t>(z) * R * D;
      float4 o[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k)
        if (off[k] >= 0)
          o[k] = __ldcg(reinterpret_cast<const float4*>(pz + off[k]));
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (off[k] < 0) continue;
        const float w =
            s_ml[z * wstride + ((k0 + k) * NT + threadIdx.x) / C].x;
        a[k][0] = fmaf(w, o[k].x, a[k][0]);
        a[k][1] = fmaf(w, o[k].y, a[k][1]);
        a[k][2] = fmaf(w, o[k].z, a[k][2]);
        a[k][3] = fmaf(w, o[k].w, a[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (off[k] < 0) continue;
      T* dst = out + off[k];
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[i] = ptt::from_f<T>(a[k][i]);
    }
  }
}

// The rows' results of split z, held in shared memory (res_m, res_l per
// row; res_o [nrows][D], o unnormalised): the output when the group has
// one live split, else a partial, then the merge by the last block
// (merge_rows: at most MAXR rows, NT threads).
template <typename T, int D, int MAXR, int NT>
__device__ void finish_split(const int* rows, int nrows, const float* res_m,
                             const float* res_l, const float* res_o, int z,
                             int n_live, int R, float* part_o,
                             float2* part_ml, int* ticket,
                             T* __restrict__ out, float2* s_ml,
                             int wstride) {
  if (n_live == 1) {
    for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
      const int r = e / D;
      const int row = rows[r];
      if (row < 0) continue;
      const float l = res_l[r];
      out[static_cast<size_t>(row) * D + e % D] =
          ptt::from_f<T>(l == 0.f ? 0.f : res_o[e] / l);   // NaN stays
    }
    return;
  }
  for (int e = threadIdx.x; e < nrows * D; e += blockDim.x) {
    const int r = e / D;
    const int row = rows[r];
    if (row < 0) continue;
    part_o[(static_cast<size_t>(z) * R + row) * D + e % D] = res_o[e];
    if (e % D == 0)
      part_ml[static_cast<size_t>(z) * R + row] =
          make_float2(res_m[r], res_l[r]);
  }
  if (ticket_last(ticket, n_live))
    merge_rows<T, D, MAXR, NT>(rows, nrows, n_live, R, part_o, part_ml, out,
                               s_ml, wstride);
}

// The decode walk: G query rows (one 16-byte slice of each per lane,
// pre-scaled in q's dtype, then times LOG2E in f32, in qr) over keys
// [k0, k1) of one split, key j valid for row
// g while j < nvis[g]. Lanes over d: a key row is read as 16-byte vectors
// by D / VEC lanes, so a warp reads 32 * VEC / D keys at once, and each
// lane issues UNROLL keys' K and V loads before it uses any. A key's
// score is its lanes' partial dot reduced by shuffles; each lane group
// keeps its own online softmax (m, l, acc) in f32 per row, rescaled once
// a round (UNROLL keys), merged by
// shuffles within a warp; each warp leaves its (m, l, acc) in s_m, s_l
// [WARPS][G] and s_acc [WARPS][G][D]. kbase / vbase point at the kv head
// and the lane's slice; s_pages at the page of key k0.
template <typename T, int D, int G, int WARPS, int UNROLL>
__device__ __forceinline__ void walk_split(
    const float (&qr)[G][16 / sizeof(T)], const int (&nvis)[G], int k0,
    int k1, const int* s_pages, int page, const T* __restrict__ kbase,
    const T* __restrict__ vbase, long long s_page, long long s_tok,
    float* s_m, float* s_l, float* s_acc) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int LPK = D / VEC;            // lanes per key row
  constexpr int KPW = 32 / LPK;           // keys a warp reads at once
  constexpr int STRIDE = WARPS * KPW;     // keys the block reads at once
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;             // which key of the warp's KPW
  const int sl = lane % LPK;              // which vector of the key row
  const PageOf pof(page);

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  }
  for (int j0 = k0; j0 < k1; j0 += STRIDE * UNROLL) {
    uint4 kv[UNROLL], vv[UNROLL];
    int jj[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * STRIDE + warp * KPW + sub;
      jj[u] = j;
      if (j < k1) {
        const long long off =
            s_pages[pof.index(j - k0)] * s_page + pof.token(j) * s_tok;
        kv[u] = *reinterpret_cast<const uint4*>(kbase + off);
        vv[u] = *reinterpret_cast<const uint4*>(vbase + off);
      } else {
        kv[u] = make_uint4(0u, 0u, 0u, 0u);
        vv[u] = kv[u];
      }
    }
    // the round's scores, then one rescale and the round's P V per row
    float sc[G][UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* ke = reinterpret_cast<const T*>(&kv[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          part = fmaf(qr[g][i], ptt::to_f(ke[i]), part);
        // every lane shuffles (a key's lanes are one aligned group)
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[g][u] = jj[u] < k1 && jj[u] < nvis[g] ? part : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float cmax = -INFINITY;
      bool bad = false;                     // a valid key scored NaN
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        cmax = fmaxf(cmax, sc[g][u]);       // fmaxf drops a NaN
        bad |= isnan(sc[g][u]);
      }
      // no key of this row here; a NaN score (fmaxf left cmax at -inf if
      // it was the round's only one) goes on, so that l and acc turn NaN
      // as the softmax would
      if (cmax == -INFINITY && !bad) continue;
      const float m_new = fmaxf(m[g], cmax);
      const float alpha = exp2f(m[g] - m_new);  // 0 while m is -inf
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const T* ve = reinterpret_cast<const T*>(&vv[u]);
        const float p = exp2f(sc[g][u] - m_new);  // 0 for a masked key
        l[g] += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[g][i] = fmaf(p, ptt::to_f(ve[i]), acc[g][i]);
      }
      m[g] = m_new;
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
      const float a = m[g] == -INFINITY ? 0.f : exp2f(m[g] - mn);
      const float c = mo == -INFINITY ? 0.f : exp2f(mo - mn);
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
      for (int i = 0; i < VEC; ++i)
        s_acc[(warp * G + g) * D + sl * VEC + i] = acc[g][i];
      if (sl == 0) {
        s_m[warp * G + g] = m[g];
        s_l[warp * G + g] = l[g];
      }
    }
  }
}

// Merge the warps' (m, l, acc) of the walk for rows g < nq: the split's
// m and l per row into res_m, res_l, its unnormalised o into s_acc's
// first warp slot ([G][D]). Call between two __syncthreads.
template <int G, int D, int WARPS>
__device__ __forceinline__ void combine_warps(const float* s_m,
                                              const float* s_l, float* s_acc,
                                              int nq, float* res_m,
                                              float* res_l) {
  for (int idx = threadIdx.x; idx < nq * D; idx += blockDim.x) {
    const int g = idx / D;
    const int dd = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, s_m[w * G + g]);
    // a warp with no key has l = 0 and acc = 0 and weighs 0; a NaN l or
    // acc (a NaN score) stays NaN, whatever its weight
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = s_m[w * G + g];
      const float c = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      lsum += s_l[w * G + g] * c;
      o += s_acc[(w * G + g) * D + dd] * c;
    }
    s_acc[g * D + dd] = o;
    if (dd == 0) {
      res_m[g] = mx;
      res_l[g] = lsum;
    }
  }
}

}  // namespace paged
}  // namespace ptt
