// Fused residual add + RMSNorm forward: h = x + residual, rounded to the
// stream dtype; y = h * rsqrt(mean(h^2) + eps) * w with f32 math. Emits
// both y and h; w is f32.
//
// Replaces: paddle_tpu/kernels/fused_norm_residual.py::fused_add_rms_norm
//   (_fwd_impl -> _fwd_kernel, the row-blocked Pallas kernel).
// Bound on the H100: bytes. Each row of x and residual is read once and
//   y and h written once (about 5 flops per element against 8 bytes of
//   traffic in bf16); at the training slice's [8192, 2048] bf16 the call
//   moves 134 MB.
// Design: one block per row. x and residual are
//   read once with 16-byte vector loads; h is formed in f32 and rounded
//   to the stream dtype BEFORE it is squared and summed (the unfused
//   path norms the rounded stream, and the kill-switch parity depends on
//   it), written to device memory and staged in shared memory; a
//   warp-shuffle + shared-memory reduction gives the row's rsqrt; the
//   second pass re-reads h from shared memory and writes (h * r) * w.
//   Requires H % 8 == 0 and 16-byte aligned rows (the wrapper checks).

#include "common.cuh"

namespace {

template <typename T>
__global__ void fused_add_rms_norm_kernel(const T* __restrict__ x,
                                          const T* __restrict__ res,
                                          const float* __restrict__ w,
                                          T* __restrict__ y,
                                          T* __restrict__ h, int H,
                                          float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* row_s = reinterpret_cast<uint4*>(smem_raw);
  __shared__ float warp_part[32];
  __shared__ float r_shared;

  constexpr int V = ptt::Vec<T>::N;
  const int nvec = H / V;
  const size_t base = static_cast<size_t>(blockIdx.x) * H;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  const uint4* rv = reinterpret_cast<const uint4*>(res + base);
  uint4* hv = reinterpret_cast<uint4*>(h + base);
  uint4* yv = reinterpret_cast<uint4*>(y + base);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 xr = xv[i];
    const uint4 rr = rv[i];
    const T* xe = reinterpret_cast<const T*>(&xr);
    const T* re = reinterpret_cast<const T*>(&rr);
    uint4 out;
    T* he = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      he[j] = ptt::from_f<T>(ptt::to_f(xe[j]) + ptt::to_f(re[j]));
      const float f = ptt::to_f(he[j]);
      ss += f * f;
    }
    row_s[i] = out;
    hv[i] = out;
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
    const uint4 raw = row_s[i];
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
int launch(const void* x, const void* res, const void* w, void* y, void* h,
           int rows, int H, float eps, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  constexpr int V = ptt::Vec<T>::N;
  const int nvec = H / V;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = static_cast<size_t>(H) * sizeof(T);
  fused_add_rms_norm_kernel<T><<<rows, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(w), static_cast<T*>(y), static_cast<T*>(h),
      H, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptt_fused_add_rms_norm_bf16(const void* x, const void* res,
                                           const void* w, void* y, void* h,
                                           int rows, int H, float eps,
                                           void* stream) {
  return launch<__nv_bfloat16>(x, res, w, y, h, rows, H, eps, stream);
}

extern "C" int ptt_fused_add_rms_norm_f32(const void* x, const void* res,
                                          const void* w, void* y, void* h,
                                          int rows, int H, float eps,
                                          void* stream) {
  return launch<float>(x, res, w, y, h, rows, H, eps, stream);
}
