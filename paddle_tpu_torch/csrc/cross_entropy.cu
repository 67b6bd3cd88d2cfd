// Fused softmax cross-entropy over large vocabularies, forward and
// backward, f32 math, logits in bf16 or f32, labels int32 or int64.
//
// Replaces: paddle_tpu/kernels/cross_entropy.py::fused_cross_entropy
//   (_fwd -> _fwd_kernel, the row-block x vocab-block Pallas kernel
//   carrying (m, l) in VMEM scratch along a sequential vocab axis) and
//   _bwd_rule -> _bwd_kernel.
// Bound on the H100: bytes. The forward reads each logit once (a few
//   flops each, far below the ~295 flop/byte ridge) and writes three f32
//   numbers a row; the backward reads each logit once and writes dx once.
//   At the training slice's [8188, 32000] bf16 that is 524 MB (0.156 ms)
//   and 1.05 GB (0.313 ms).
// Design: one block per row; the TPU's sequential vocab grid axis is a
//   loop inside the block. Forward: each thread walks its share of the
//   row in 16-byte vectors (UNROLL of them in flight), keeping an online
//   (max m, sum-exp l) in f32; the (m, l) pairs merge by warp shuffles,
//   then across warps in shared memory. The label's logit is read once,
//   directly, when 0 <= label < V; any other label that is not
//   ignore_index contributes 0 (the reference's one-hot never hits) and
//   nothing out of bounds is read. loss = log l + m - x[label], 0 on
//   ignore_index rows. Backward: 1/l and g * valid once per row, then
//   dx = (exp(x - m) / l - [col == label]) * g * valid element by
//   element, written with 16-byte stores.
//   Rows whose start is not 16-byte aligned (V % 8 != 0 in bf16) take a
//   scalar head up to the first boundary and a scalar tail after the
//   last whole vector. The wrapper passes 16-byte aligned bases, so x and
//   dx rows share their alignment.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr float kNegInit = -1e30f;  // the reference's _NEG_INF

__device__ __forceinline__ long long read_label(const void* labels,
                                                int label64, int row) {
  return label64 ? static_cast<const long long*>(labels)[row]
                 : static_cast<long long>(static_cast<const int*>(labels)[row]);
}

// elements of a row before its first 16-byte boundary
template <typename T>
__device__ __forceinline__ int row_head(const T* row, int V) {
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(row) & 15u);
  const int head = static_cast<int>(((16u - mis) & 15u) / sizeof(T));
  return head < V ? head : V;
}

__device__ __forceinline__ void online_add(float& m, float& l, float v) {
  if (v > m) {
    l = l * __expf(m - v);
    m = v;
  }
  l += __expf(v - m);
}

__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * __expf(m - mn) + l2 * __expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ x, const void* __restrict__ labels,
                  int label64, float* __restrict__ loss,
                  float* __restrict__ m_out, float* __restrict__ l_out,
                  int V, long long ignore_index) {
  constexpr int VN = ptt::Vec<T>::N;
  __shared__ float m_part[kThreads / 32];
  __shared__ float l_part[kThreads / 32];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * V;
  const int head = row_head(xr, V);
  const int nvec = (V - head) / VN;
  const int tail = head + nvec * VN;

  float m = kNegInit, l = 0.f;
  for (int j = threadIdx.x; j < head; j += kThreads)
    online_add(m, l, ptt::to_f(xr[j]));
  for (int j = tail + threadIdx.x; j < V; j += kThreads)
    online_add(m, l, ptt::to_f(xr[j]));

  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nvec) raw[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i0 + u * kThreads >= nvec) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      float v[VN];
      float vmax = kNegInit;
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        v[j] = ptt::to_f(e[j]);
        vmax = fmaxf(vmax, v[j]);
      }
      if (vmax > m) {
        l = l * __expf(m - vmax);
        m = vmax;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) l += __expf(v[j] - m);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    m_part[warp] = m;
    l_part[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_part[0];
    l = l_part[0];
    for (int w = 1; w < kThreads / 32; ++w) merge(m, l, m_part[w], l_part[w]);
    const long long lbl = read_label(labels, label64, row);
    const float xl = (lbl >= 0 && lbl < V)
                         ? ptt::to_f(xr[static_cast<int>(lbl)])
                         : 0.f;
    loss[row] = lbl == ignore_index ? 0.f : logf(l) + m - xl;
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename T>
__device__ __forceinline__ T ce_grad(float v, float m, float inv_l,
                                     float gv, int col, long long lbl) {
  const float p = __expf(v - m) * inv_l;
  return ptt::from_f<T>((p - (col == lbl ? 1.f : 0.f)) * gv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ x, const void* __restrict__ labels,
                  int label64, const float* __restrict__ m_in,
                  const float* __restrict__ l_in,
                  const float* __restrict__ g, T* __restrict__ dx, int V,
                  long long ignore_index) {
  constexpr int VN = ptt::Vec<T>::N;
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * V;
  const T* xr = x + base;
  T* dr = dx + base;
  const long long lbl = read_label(labels, label64, row);
  const float m = m_in[row];
  const float inv_l = 1.f / l_in[row];
  const float gv = lbl == ignore_index ? 0.f : g[row];
  const int head = row_head(xr, V);
  const int nvec = (V - head) / VN;
  const int tail = head + nvec * VN;

  for (int j = threadIdx.x; j < head; j += kThreads)
    dr[j] = ce_grad<T>(ptt::to_f(xr[j]), m, inv_l, gv, j, lbl);
  for (int j = tail + threadIdx.x; j < V; j += kThreads)
    dr[j] = ce_grad<T>(ptt::to_f(xr[j]), m, inv_l, gv, j, lbl);

  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* dv = reinterpret_cast<uint4*>(dr + head);
  for (int i0 = threadIdx.x; i0 < nvec; i0 += kThreads * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nvec) raw[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= nvec) break;
      const T* e = reinterpret_cast<const T*>(&raw[u]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
      const int col0 = head + i * VN;
#pragma unroll
      for (int j = 0; j < VN; ++j)
        o[j] = ce_grad<T>(ptt::to_f(e[j]), m, inv_l, gv, col0 + j, lbl);
      dv[i] = out;
    }
  }
}

template <typename T>
int launch_fwd(const void* x, const void* labels, int label64, void* loss,
               void* m, void* l, int N, int V, long long ignore_index,
               void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  ce_fwd_kernel<T><<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), labels, label64, static_cast<float*>(loss),
      static_cast<float*>(m), static_cast<float*>(l), V, ignore_index);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* labels, int label64, const void* m,
               const void* l, const void* g, void* dx, int N, int V,
               long long ignore_index, void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  ce_bwd_kernel<T><<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), labels, label64,
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(g), static_cast<T*>(dx), V, ignore_index);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_cross_entropy_fwd_bf16(const void* x, const void* labels,
                                          int label64, void* loss, void* m,
                                          void* l, int N, int V,
                                          long long ignore_index,
                                          void* stream) {
  return launch_fwd<__nv_bfloat16>(x, labels, label64, loss, m, l, N, V,
                                   ignore_index, stream);
}

extern "C" int ptt_cross_entropy_fwd_f32(const void* x, const void* labels,
                                         int label64, void* loss, void* m,
                                         void* l, int N, int V,
                                         long long ignore_index,
                                         void* stream) {
  return launch_fwd<float>(x, labels, label64, loss, m, l, N, V,
                           ignore_index, stream);
}

extern "C" int ptt_cross_entropy_bwd_bf16(const void* x, const void* labels,
                                          int label64, const void* m,
                                          const void* l, const void* g,
                                          void* dx, int N, int V,
                                          long long ignore_index,
                                          void* stream) {
  return launch_bwd<__nv_bfloat16>(x, labels, label64, m, l, g, dx, N, V,
                                   ignore_index, stream);
}

extern "C" int ptt_cross_entropy_bwd_f32(const void* x, const void* labels,
                                         int label64, const void* m,
                                         const void* l, const void* g,
                                         void* dx, int N, int V,
                                         long long ignore_index,
                                         void* stream) {
  return launch_bwd<float>(x, labels, label64, m, l, g, dx, N, V,
                           ignore_index, stream);
}
