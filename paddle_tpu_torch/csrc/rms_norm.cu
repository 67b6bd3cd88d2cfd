// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * w, f32 math, output
// in the input dtype; w is f32.
//
// Replaces: paddle_tpu/kernels/rms_norm.py::rms_norm (_fwd_impl ->
//   _rms_kernel, the row-blocked Pallas kernel).
// Bound on the H100: bytes. Each row is read once and written once
//   (4 flops per element against 4 bytes of traffic in bf16 — far below
//   the ~295 flop/byte ridge); at the serving slice's [128, 4096] bf16
//   the whole call moves 2 MB, so launch latency dominates.
// Design: one block per row. The row is read once with 16-byte vector
//   loads into shared memory while each thread accumulates its share
//   of sum(x^2) in f32; a warp-shuffle + shared-memory reduction gives
//   the row's rsqrt; the second pass re-reads the row from shared memory
//   (not device memory) and writes (x * r) * w with 16-byte stores.
//   Requires H % 8 == 0 and 16-byte aligned rows (the wrapper checks).

#include "common.cuh"

namespace {

template <typename T>
__global__ void rms_norm_kernel(const T* __restrict__ x,
                                const float* __restrict__ w,
                                T* __restrict__ y, int H, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* row_s = reinterpret_cast<uint4*>(smem_raw);
  __shared__ float warp_part[32];
  __shared__ float r_shared;

  constexpr int V = ptt::Vec<T>::N;
  const int nvec = H / V;
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  uint4* yv = reinterpret_cast<uint4*>(y + base);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = xv[i];
    row_s[i] = raw;
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float f = ptt::to_f(e[j]);
      ss += f * f;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  ss = ptt::warp_sum(ss);
  if (lane == 0) warp_part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float v = lane < nwarps ? warp_part[lane] : 0.f;
    v = ptt::warp_sum(v);
    if (lane == 0) r_shared = rsqrtf(v / static_cast<float>(H) + eps);
  }
  __syncthreads();
  const float r = r_shared;

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    uint4 raw = row_s[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 out;
    T* o = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = ptt::from_f<T>(ptt::to_f(e[j]) * r * w[i * V + j]);
    yv[i] = out;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int H, float eps,
           void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  constexpr int V = ptt::Vec<T>::N;
  const int nvec = H / V;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = static_cast<size_t>(H) * sizeof(T);
  rms_norm_kernel<T><<<rows, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_rms_norm_bf16(const void* x, const void* w, void* y,
                                 int rows, int H, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, rows, H, eps, stream);
}

extern "C" int ptt_rms_norm_f32(const void* x, const void* w, void* y,
                                int rows, int H, float eps, void* stream) {
  return launch<float>(x, w, y, rows, H, eps, stream);
}
