// Weight-only int8 linear (W8A16): out[M, N] = a[M, K] @ deq(q)[K, N],
// with q int8 in the [in, out] layout and
//   deq(q)[k, n] = round_to_T(f32(q[k, n]) * s[k / group, n])
// (s f32; per column: one row, group = K; per tensor: one value; per
// group: [K / group, N], group a multiple of 64). a and out are bf16 or
// f16 (T); the products accumulate in f32. Two epilogues, two C entries
// each:
//   `weight_only_linear`: out = round_to_T(acc), then, with a bias,
//     round_to_T(out + bias[n]) (the product, then the add, each rounded
//     as PyTorch rounds `a @ w + b`);
//   `weight_only_swiglu`: q = [Qg | Qu] is [K, 2 Mh] (gate columns
//     first, as swiglu.cu's w_gate_up) and out[M, Mh] = silu(g) * u of
//     the f32 accumulators, swiglu.cu's epilogue and float order, so the
//     int8 MLP never stores its [M, 2 Mh] gate/up product.
//
// Replaces: no Pallas kernel. The reference dequantizes the int8 state
//   in the serving step's trace and leaves the convert + scale to XLA's
//   fusion into the dot's operand read (paddle_tpu/inference/
//   serving.py:263-268, `_dequant_state`; incubate/nn/functional/
//   __init__.py:352, `weight_only_linear`). A plain PyTorch port would
//   dequantize to a bf16 copy and then call cuBLAS: 1 byte a weight read,
//   2 written and 2 read again, where bf16 weights cost 2. This kernel
//   reads the int8 bytes once and never writes a dequantized weight.
// Bound on the H100: at the serving shapes (M = 4 decode rows to 128
//   packed rows; llama_7b's K in {4096, 11008}, N in {4096, 12288, 22016,
//   32000}) the int8 weight read: 16.8-90.2 MB a product, 5.0-26.9 us at
//   3.35 TB/s, against 2MKN = 0.13-23.1 GFLOP (0.13-23.4 us at 989
//   TFLOP/s): bytes below ~128 rows, operations at 128 rows for the
//   widest products.
// Design (simple and right first; wgmma and TMA wait for a later
//   redesign): swiglu.cu's mma_kernel with B staged differently. A block
//   owns a 64 x 128 output tile (plain; 64 gate and the same 64 up
//   columns with the SwiGLU epilogue) and walks K in steps of 64 through
//   a 4-slot cp.async ring that holds the bf16/f16 A tile and the raw
//   int8 B tile. Each step all 256 threads dequantize the landed int8
//   tile into one [64][136] T tile in shared memory by the formula above
//   (every value equals the plain version's dequantized weight bitwise),
//   then 8 warps of 32 x 32 run mma.sync m16n8k16 over ldmatrix loads.
//   A thread's scales sit in registers: per column read once a block,
//   per group the next step's loaded behind the current step's products
//   (a global load in each step's dequant had put its latency on the
//   step's critical path).
//   Row tiles are the fastest grid dimension, so the blocks of one
//   column tile run together and read its weight bytes from L2 once.
//   Each output element sums over K in one fixed order (K steps in
//   order, 16-deep slices in order) that depends neither on M nor on the
//   row's place in its tile: there is no split-K, so a row of an M-row
//   product is bitwise the 1-row product of that row. Ragged M, N and K
//   edges are masked: cp.async zero-fills, the dequant writes 0 past K,
//   the epilogue skips rows and columns out of range; where rows are not
//   whole 16-byte vectors (K % 8 for a, N % 16 for q) the tiles load
//   through registers element by element.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 64, TN = 128, TK = 64;
constexpr int NSTAGE = 4;
constexpr int THREADS = 256;
constexpr int LDA = TK + 8;     // A tile [TM][LDA], T elements
constexpr int LDQ = TN + 16;    // int8 tile [TK][LDQ], bytes
constexpr int LDB = TN + 8;     // dequantized tile [TK][LDB], T elements
constexpr int A_BYTES = TM * LDA * 2;
constexpr int Q_BYTES = TK * LDQ;
constexpr int STAGE_BYTES = A_BYTES + Q_BYTES;
constexpr int B_BYTES = TK * LDB * 2;
constexpr int SMEM_BYTES = NSTAGE * STAGE_BYTES + B_BYTES;

template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ float to_f(bf16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ bf16 from_f(float v) {
    return __float2bfloat16(v);
  }
  static __device__ __forceinline__ bf16 zero() { return __float2bfloat16(0.f); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return ptt::pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    ptt::mma_bf16_16816(d, a, b);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ float to_f(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ __half from_f(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ __half zero() { return __float2half_rn(0.f); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// Rows [m0, m0 + TM) x columns [k0, k0 + TK) of a [M, K] into dst[TM][LDA];
// out of range is zero. a_vec: K % 8 == 0 and a 16-byte aligned base.
template <typename T>
__device__ __forceinline__ void load_a(T* dst, const T* __restrict__ A, int m0,
                                       int k0, int M, int K, int a_vec) {
  for (int v = threadIdx.x; v < TM * TK / 8; v += THREADS) {
    const int r = v / (TK / 8);
    const int c = (v % (TK / 8)) * 8;
    const int gr = m0 + r;
    const int gc = k0 + c;
    T* d = dst + r * LDA + c;
    if (a_vec) {
      const bool in = gr < M && gc < K;
      ptt::cp_async16(d, in ? A + static_cast<size_t>(gr) * K + gc : A,
                      in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = (gr < M && gc + j < K) ? A[static_cast<size_t>(gr) * K + gc + j]
                                      : Elem<T>::zero();
    }
  }
}

// The tile's column c of the int8 stage: its column within the output
// (`in_half`, valid below Nv) and its column in q (`col`). Plain: n0 + c.
// GU: the first TN / 2 are gate columns n0 + c, the rest the same up
// columns, Nv further on.
template <bool GU>
__device__ __forceinline__ void q_column(int c, int n0, int Nv, int* in_half,
                                         int* col) {
  if (GU) {
    *in_half = n0 + c % (TN / 2);
    *col = (c / (TN / 2)) * Nv + *in_half;
  } else {
    *in_half = n0 + c;
    *col = *in_half;
  }
}

// Rows [k0, k0 + TK) of q [K, ldg] at the tile's columns into dst[TK][LDQ];
// out of range is zero. q_vec: Nv % 16 == 0 and a 16-byte aligned base.
template <bool GU>
__device__ __forceinline__ void load_q(int8_t* dst,
                                       const int8_t* __restrict__ Q, int n0,
                                       int k0, int K, int Nv, size_t ldg,
                                       int q_vec) {
  for (int v = threadIdx.x; v < TK * TN / 16; v += THREADS) {
    const int r = v / (TN / 16);
    const int c = (v % (TN / 16)) * 16;
    const int gk = k0 + r;
    int gc, col;
    q_column<GU>(c, n0, Nv, &gc, &col);
    int8_t* d = dst + r * LDQ + c;
    if (q_vec) {
      const bool in = gk < K && gc < Nv;
      ptt::cp_async16(d, in ? Q + gk * ldg + col : Q, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = (gk < K && gc + j < Nv) ? Q[gk * ldg + col + j] : int8_t(0);
    }
  }
}

// The scales of this thread's columns 4 (t % 32) .. + 3 for the K step at
// k0 (0 past the output's columns). The K step lies in one scale row
// (group % TK == 0, or one row in all: s_rs == 0).
template <bool GU>
__device__ __forceinline__ void load_scales(float (&s)[4],
                                            const float* __restrict__ S,
                                            int n0, int k0, int Nv, int group,
                                            long long s_rs, long long s_cs) {
  const int c = (threadIdx.x & 31) * 4;
  const long long srow = static_cast<long long>(k0 / group) * s_rs;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int gc, col;
    q_column<GU>(c + e, n0, Nv, &gc, &col);
    s[e] = gc < Nv ? S[srow + col * s_cs] : 0.f;
  }
}

// The landed int8 tile -> the T tile Bs[TK][LDB]: deq = round_to_T(f32(q)
// * s), 0 past K. Thread t owns columns 4 (t % 32) .. + 3 and rows
// 8 (t / 32) .. + 7: one 4-byte shared read and one 8-byte write a row.
template <typename T>
__device__ __forceinline__ void dequant(T* Bs, const int8_t* Qs,
                                        const float (&s)[4], int k0, int K) {
  const int c = (threadIdx.x & 31) * 4;
  const int r0 = (threadIdx.x >> 5) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + i;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(Qs + r * LDQ + c);
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = static_cast<float>(static_cast<int8_t>((w >> (8 * e)) & 0xffu)) *
             s[e];
    if (k0 + r >= K) v[0] = v[1] = v[2] = v[3] = 0.f;
    uint2 out;
    out.x = Elem<T>::pack(v[0], v[1]);
    out.y = Elem<T>::pack(v[2], v[3]);
    *reinterpret_cast<uint2*>(Bs + r * LDB + c) = out;
  }
}

// a ring slot's A tile and int8 tile
template <typename T>
__device__ __forceinline__ T* stage_a(unsigned char* smem, int st) {
  return reinterpret_cast<T*>(smem + st * STAGE_BYTES);
}

__device__ __forceinline__ int8_t* stage_q(unsigned char* smem, int st) {
  return reinterpret_cast<int8_t*>(smem + st * STAGE_BYTES + A_BYTES);
}

template <typename T, bool GU>
__global__ void __launch_bounds__(THREADS)
w8a16_kernel(const T* __restrict__ A, const int8_t* __restrict__ Q,
             const float* __restrict__ S, const T* __restrict__ bias,
             T* __restrict__ out, int M, int K, int Nv, int group,
             long long s_rs, long long s_cs, int a_vec, int q_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* Bs = reinterpret_cast<T*>(smem + NSTAGE * STAGE_BYTES);

  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * (GU ? TN / 2 : TN);
  const size_t ldg = GU ? 2 * static_cast<size_t>(Nv) : Nv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 32;
  const int wn = warp & 3;
  const int li = lane >> 3;
  const int lr = lane & 7;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // per-column and per-tensor scales are read once a block
  float s[4];
  load_scales<GU>(s, S, n0, 0, Nv, group, s_rs, s_cs);
  const int KT = (K + TK - 1) / TK;
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < KT) {
      load_a<T>(stage_a<T>(smem, st), A, m0, st * TK, M, K, a_vec);
      load_q<GU>(stage_q(smem, st), Q, n0, st * TK, K, Nv, ldg, q_vec);
    }
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    ptt::cp_async_wait<NSTAGE - 2>();   // step kt has landed
    __syncthreads();                    // ... for every thread; step kt-1's
                                        // slot and Bs are free
    const int nk = kt + NSTAGE - 1;
    if (nk < KT) {
      load_a<T>(stage_a<T>(smem, nk % NSTAGE), A, m0, nk * TK, M, K, a_vec);
      load_q<GU>(stage_q(smem, nk % NSTAGE), Q, n0, nk * TK, K, Nv, ldg, q_vec);
    }
    ptt::cp_async_commit();

    dequant<T>(Bs, stage_q(smem, kt % NSTAGE), s, kt * TK, K);
    // a group scale's next row loads behind this step's products
    if (s_rs != 0 && kt + 1 < KT)
      load_scales<GU>(s, S, n0, (kt + 1) * TK, Nv, group, s_rs, s_cs);
    __syncthreads();

    const T* As = stage_a<T>(smem, kt % NSTAGE);
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ptt::ldmatrix_x4(af[mi], As + (wm + mi * 16 + (lane & 15)) * LDA + kk +
                                     (lane >> 4) * 8);
      uint32_t bfr[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        // two n8 tiles: matrices (k, n) = (0,0) (8,0) (0,8) (8,8)
        const int nb = GU ? p * (TN / 2) + wn * 16 : wn * 32 + p * 16;
        uint32_t r[4];
        ptt::ldmatrix_x4_trans(
            r, Bs + (kk + lr + (li & 1) * 8) * LDB + nb + (li >> 1) * 8);
        bfr[2 * p][0] = r[0];
        bfr[2 * p][1] = r[1];
        bfr[2 * p + 1][0] = r[2];
        bfr[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          Elem<T>::mma(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  ptt::cp_async_wait<0>();

  const int g = lane >> 2;
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + mi * 16 + g + h * 8;
      if (r >= M) continue;
      T* row = out + static_cast<size_t>(r) * Nv;
      if constexpr (GU) {
        // n8 tiles 0, 1 are gate columns, 2, 3 the same up columns
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wn * 16 + ni * 8 + t2 + e;
            if (c < Nv)
              row[c] = Elem<T>::from_f(
                  silu_mul(acc[mi][ni][h * 2 + e], acc[mi][ni + 2][h * 2 + e]));
          }
      } else {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + wn * 32 + ni * 8 + t2 + e;
            if (c >= Nv) continue;
            T v = Elem<T>::from_f(acc[mi][ni][h * 2 + e]);
            if (bias != nullptr)
              v = Elem<T>::from_f(Elem<T>::to_f(v) + Elem<T>::to_f(bias[c]));
            row[c] = v;
          }
      }
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Nv: output columns (plain: q's N; SwiGLU: Mh, q being [K, 2 Mh])
template <typename T, bool GU>
int w8a16_launch(const void* a, const void* q, const void* s, const void* bias,
                 void* out, int M, int K, int Nv, int group, long long s_rs,
                 long long s_cs, cudaStream_t stream) {
  if (M <= 0 || Nv <= 0) return static_cast<int>(cudaSuccess);
  if (group <= 0 || (s_rs != 0 && group % TK != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = w8a16_kernel<T, GU>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int a_vec = (K % 8 == 0) && aligned16(a);
  const int q_vec = (Nv % 16 == 0) && aligned16(q);
  const int n_step = GU ? TN / 2 : TN;
  dim3 grid((M + TM - 1) / TM, (Nv + n_step - 1) / n_step);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(a), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<const T*>(bias),
      static_cast<T*>(out), M, K, Nv, group, s_rs, s_cs, a_vec, q_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M, K], q int8 [K, N], s f32 (element (k, n) at (k / group) * s_rs +
// n * s_cs), bias [N] or null, out [M, N]
extern "C" int ptt_weight_only_linear_bf16(const void* a, const void* q,
                                           const void* s, const void* bias,
                                           void* out, int M, int K, int N,
                                           int group, long long s_rs,
                                           long long s_cs, void* stream) {
  return w8a16_launch<bf16, false>(a, q, s, bias, out, M, K, N, group, s_rs,
                                   s_cs, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_weight_only_linear_f16(const void* a, const void* q,
                                          const void* s, const void* bias,
                                          void* out, int M, int K, int N,
                                          int group, long long s_rs,
                                          long long s_cs, void* stream) {
  return w8a16_launch<__half, false>(a, q, s, bias, out, M, K, N, group, s_rs,
                                     s_cs, static_cast<cudaStream_t>(stream));
}

// a [M, K], q int8 [K, 2 Mh] = [Qg | Qu], s as above over the 2 Mh
// columns, out [M, Mh] = silu(a @ deq(Qg)) * (a @ deq(Qu))
extern "C" int ptt_weight_only_swiglu_bf16(const void* a, const void* q,
                                           const void* s, void* out, int M,
                                           int K, int Mh, int group,
                                           long long s_rs, long long s_cs,
                                           void* stream) {
  return w8a16_launch<bf16, true>(a, q, s, nullptr, out, M, K, Mh, group, s_rs,
                                  s_cs, static_cast<cudaStream_t>(stream));
}

extern "C" int ptt_weight_only_swiglu_f16(const void* a, const void* q,
                                          const void* s, void* out, int M,
                                          int K, int Mh, int group,
                                          long long s_rs, long long s_cs,
                                          void* stream) {
  return w8a16_launch<__half, true>(a, q, s, nullptr, out, M, K, Mh, group,
                                    s_rs, s_cs,
                                    static_cast<cudaStream_t>(stream));
}
