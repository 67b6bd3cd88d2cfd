// RMSNorm forward: y = (x * r) * w with r = rsqrt(sum(x^2) / H + eps), f32
// math, output in the input dtype; w is f32.
//
// Replaces: paddle_tpu/kernels/rms_norm.py::rms_norm (_fwd_impl ->
//   _rms_kernel, the row-blocked Pallas kernel).
// Bound on the H100: bytes. Each row is read once and written once (4
//   flops per element against 4 bytes of traffic in bf16, far below the
//   ~295 flop/byte ridge). At the serving and decode row counts ([128,
//   4096] and [4, 4096] bf16: 2 MB and 64 KB a call) the bytes take less
//   than a launch's own latency, so what is left there is one
//   load-reduce-store round trip on the card and the host's enqueue (see
//   kernels/rms_norm.py); at the training row counts (8192 rows) it is
//   the bytes.
// Design: the first design ran one block per row, staged the row in
//   shared memory behind two barriers and re-read the f32 weight from L2
//   for every row (at H = 4096, 4 bytes an element: as many as the row's
//   own bf16 read and write). Here a persistent grid (`grid` blocks, from
//   the wrapper's plan, kernels/rms_norm.py::plan: at most the card's 132
//   SMs times the blocks that fit on one) walks the rows, `rpb` rows a
//   block at a time, each row owned by `wpr` warps. A lane holds its VPT
//   16-byte vectors of the row in registers (lane t of a row's 32 wpr
//   threads owns vectors t, t + 32 wpr, ...): each element is read once
//   with a 16-byte load and written once with a 16-byte store, and never
//   goes through shared memory. The lane's slice of the weight is the same
//   for every row, so it is loaded once a block, into registers. The
//   row's sum of squares is reduced by warp shuffles and, where a row
//   spans warps, one exchange of per-warp partials through shared memory
//   (double-buffered: one barrier a row group; none when a row is one
//   warp). Latency is hidden by occupancy: the plan keeps up to 24 warps,
//   each with its VPT loads in flight, resident on an SM; few rows (the
//   decode step's 4) instead spread each row over up to 16 warps, one
//   vector a lane. Requires H % 8 == 0 and 16-byte aligned rows and
//   weight (the wrapper checks).

#include "common.cuh"

namespace {

// a block of at most 768 threads, which caps a thread at 80 registers:
// room for 4 vectors of bf16 x (16) and their f32 weights (32) unspilled
constexpr int kMaxWarps = 24;

template <typename T, int VPT>
__global__ void __launch_bounds__(32 * kMaxWarps)
rms_norm_kernel(const T* __restrict__ x, const float* __restrict__ w,
                T* __restrict__ y, int rows, int H, float eps, int wpr) {
  __shared__ float part[2][kMaxWarps];         // per-warp partial sums
  constexpr int V = ptt::Vec<T>::N;
  const int nvec = H / V;
  const int tpr = 32 * wpr;                    // threads a row
  const int rpb = blockDim.x / tpr;
  const int slot = threadIdx.x / tpr;          // the block's row of this thread
  const int t = threadIdx.x % tpr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this lane's slice of the weight, once for every row the block walks
  float wr[VPT][V];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = t + i * tpr;
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vi < nvec) f = *reinterpret_cast<const float4*>(w + vi * V + j);
      wr[i][j] = f.x;
      wr[i][j + 1] = f.y;
      wr[i][j + 2] = f.z;
      wr[i][j + 3] = f.w;
    }
  }

  // the loop count depends on blockIdx.x alone: every thread of the block
  // reaches the same barriers
  int it = 0;
  for (int g = blockIdx.x; g * rpb < rows; g += gridDim.x, ++it) {
    const int row = g * rpb + slot;
    const bool live = row < rows;
    const uint4* xv = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(live ? row : 0) * H);
    uint4 xr[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = t + i * tpr;
      xr[i] = (live && vi < nvec) ? xv[vi] : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* e = reinterpret_cast<const T*>(&xr[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = ptt::to_f(e[j]);
        ss += f * f;
      }
    }
    ss = ptt::warp_sum(ss);
    if (wpr > 1) {
      float* p = part[it & 1];
      if (lane == 0) p[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += p[slot * wpr + k];
    }
    const float r = rsqrtf(ss / static_cast<float>(H) + eps);
    if (!live) continue;
    uint4* yv = reinterpret_cast<uint4*>(y + static_cast<size_t>(row) * H);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = t + i * tpr;
      if (vi >= nvec) continue;
      const T* e = reinterpret_cast<const T*>(&xr[i]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = ptt::from_f<T>(ptt::to_f(e[j]) * r * wr[i][j]);
      yv[vi] = out;
    }
  }
}

template <typename T, int VPT>
cudaError_t launch_vpt(const void* x, const void* w, void* y, int rows, int H,
                       float eps, int wpr, int rpb, int grid,
                       cudaStream_t stream) {
  rms_norm_kernel<T, VPT><<<grid, 32 * wpr * rpb, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(y), rows, H, eps, wpr);
  return cudaGetLastError();
}

// the plan's geometry: wpr warps a row, rpb rows a block, vpt vectors a
// lane (1, 2 or 4), grid blocks; refused unless its lanes cover the row
template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int H, float eps,
           int wpr, int rpb, int vpt, int grid, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  constexpr int V = ptt::Vec<T>::N;
  if (H <= 0 || H % V || wpr < 1 || rpb < 1 || wpr * rpb > kMaxWarps ||
      grid < 1 || 32 * wpr * vpt < H / V)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vpt) {
    case 1: e = launch_vpt<T, 1>(x, w, y, rows, H, eps, wpr, rpb, grid, st); break;
    case 2: e = launch_vpt<T, 2>(x, w, y, rows, H, eps, wpr, rpb, grid, st); break;
    case 4: e = launch_vpt<T, 4>(x, w, y, rows, H, eps, wpr, rpb, grid, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // namespace

// x, y [rows, H] in one dtype, w f32 [H]; the plan's wpr, rpb, vpt, grid
extern "C" int ptt_rms_norm_bf16(const void* x, const void* w, void* y,
                                 int rows, int H, float eps, int wpr, int rpb,
                                 int vpt, int grid, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, rows, H, eps, wpr, rpb, vpt, grid,
                               stream);
}

extern "C" int ptt_rms_norm_f32(const void* x, const void* w, void* y,
                                int rows, int H, float eps, int wpr, int rpb,
                                int vpt, int grid, void* stream) {
  return launch<float>(x, w, y, rows, H, eps, wpr, rpb, vpt, grid, stream);
}
