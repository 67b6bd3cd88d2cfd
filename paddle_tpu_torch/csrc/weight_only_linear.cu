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
// Bound on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; 3.35 TB/s, 989
//   TFLOP/s bf16): at the serving shapes (M = 4 decode rows to 128
//   packed rows; llama_7b's K in {4096, 11008}, N in {4096, 12288, 22016,
//   32000}) the int8 weight read, 16.8-131 MB a product, 5.0-39 us,
//   against 2MKN = 0.13-33.6 GFLOP (0.14-34 us): bytes at every serving
//   row count, with the tensor cores close behind at 128 rows.
// What held the first design back (NVIDIA H100 80GB HBM3, 700.00 W):
//   one dequantized tile in shared memory that every K step wrote,
//   synchronised and multiplied, so a block's steps were a serial chain
//   (~1.6 us each), and N / 128 blocks (32 for the 4096-wide products on
//   132 SMs): 7-20x its bound.
// What bounds this design (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
//   row-14 phase and --w8a16-diagnose): 1.5-4.1x the bytes bound. The
//   register-A wgmma is one instruction per 1 KB of int8 (m64 x k16),
//   about 60 cycles a block each at n = 8 whatever its size, and the
//   loads overlap the products only in part; the dequant itself is
//   cheap.
// Design (sm_90a: TMA + mbarrier ring, wgmma with A from registers,
//   split-K merged in the same launch):
//   The transposed product: out^T = deq(q)^T a^T. The dequantized weight
//   is wgmma's A operand, straight from registers, and the activations
//   are B, an [n][64 k] tile in the 128-byte swizzle with n the rows
//   rounded up to 8, 32, 64 or 128 (wgmma m64nNk16): a decode product
//   wastes no tensor-core rows, and no dequantized value goes through
//   shared memory. A block owns a column tile of 128 int8 columns
//   (plain: 128 outputs; SwiGLU: 64 gate and the same 64 up columns) and
//   up to 128 rows, and walks K in steps of 64. A producer warp starts
//   each stage's TMA loads (the int8 tile as two [64 k][64 byte] boxes in
//   the 64-byte swizzle, the activation tile) and copies the step's 128
//   column scales with cp.async, all completing on the stage's
//   full-barrier; the ring is as deep as shared memory allows (8-16
//   stages). Two consumer warpgroups read the same int8 bytes with
//   ldmatrix.trans (pairs of bytes as b16, so each lane gets two k of two
//   adjacent columns) and each dequantizes its column of every pair into
//   A fragments in the layout of wgmma's register operand: warpgroup y's
//   A row g is box 0's column 2g + y and row g + 8 box 1's, so SwiGLU's
//   gate and up sums of an output meet in one thread. The dequant is the
//   formula above in the plain version's float order: int8 -> f32
//   exactly by the 2^23 magic number (one byte permute and one add, no
//   I2F, whose quarter rate would bound the kernel), times the f32 scale,
//   rounded once to T; every dequantized value equals `dequantize()`'s
//   bitwise. A step commits one wgmma group a k16 slice and rewrites a
//   slice's fragment once wgmma.wait_group 3 has retired its previous
//   use, so the dequant of a slice overlaps the products of the three
//   before it, with no barrier between the warpgroups. At n = 8 (decode)
//   two blocks share an SM; above, one block has it and setmaxnreg moves
//   the producer warpgroup's registers to the consumers.
//   Split-K (`plan` in kernels/weight_only_linear.py): S <= 4 splits of
//   whole 64-row steps, S and the boundaries a function of (K, N,
//   epilogue) alone, chosen so that column tiles x S fill rounds of the
//   132 SMs where the splits' merges cost less than they save (llama_7b:
//   o and down S = 4, the rest 1). Each
//   split sums its steps from zero. At M <= 128 each block takes one
//   split of a column tile and leaves its f32 partial in scratch (per
//   thread float4s, so stores and loads are whole 512-byte rows); the
//   last block of the tile to arrive (a self-resetting ticket, as
//   paged_split.cuh::ticket_last) loads every split's share of a chunk at
//   once, adds them in split order and runs the epilogue, in the same
//   launch. Above 128 rows a block owns all S splits of its tile and adds
//   each split's fresh sums to a running f32 total in split order: the
//   same f32 operations, so every route gives the same bits and row i of
//   an M-row product is bitwise the 1-row product of row i for every M
//   (the card checks both sides of every switch of the plan, and 512).
//   Only wgmma defines the accumulators; a merge into them would make
//   ptxas serialise the products (its warning C7515).
//   Grid: persistent blocks walk the units (a split of a column tile, or
//   a row group's column tile); the ring runs on across units, so the
//   next unit's loads overlap this one's merge and epilogue. Ragged
//   edges: TMA zero-fills rows and columns out of range (a zero code
//   dequantizes to zero), the scales past the output's columns are 0,
//   the epilogue skips rows and columns out of range. Where rows are not
//   whole 16-byte vectors or a base is unaligned (K % 8 for a, the q row
//   % 16), the producer warp loads the same tiles element by element.
//   The tensor maps are encoded once per (base, shape) and cached.

#include <cuda_fp16.h>
#include <string.h>

#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hw = ptt::hopper;
using bf16 = __nv_bfloat16;

constexpr int TK = 64;                   // K step
constexpr int TQ = 128;                  // int8 columns a tile
constexpr int QBOX = 64 * 64;            // one int8 box [64 k][64 bytes]
constexpr int Q_BYTES = 2 * QBOX;        // 8 KB
constexpr int SC_BYTES = TQ * 4;         // the step's 128 scales
constexpr int MAX_STAGES = 16;
constexpr int MAX_SPLITS = 4;            // plan's cap on S
constexpr int SMEM_BLOCK = 232448;       // an H100 block's shared memory

// The ring for row groups of NP rows (the products' N): a stage holds the
// two int8 boxes, the [NP][64 k] activation tile and the scales. At NP =
// 8 (decode) two blocks share an SM: their two pipelines keep more of the
// dequant in flight, and the lm head's 250 column tiles fit one round of
// 264 blocks. Above, one block of two consumer warpgroups and a producer
// warpgroup (registers moved to the consumers by setmaxnreg) has an SM.
template <int NP>
struct Geo {
  static constexpr int BPS = NP == 8 ? 2 : 1;        // blocks an SM
  static constexpr int THREADS = BPS == 2 ? 288 : 384;
  static constexpr int A_BYTES = NP * TK * 2;
  static constexpr int STAGE_BYTES =
      (Q_BYTES + A_BYTES + SC_BYTES + 1023) / 1024 * 1024;
  // the alignment slack, the barriers, the static ticket flag, and at
  // two blocks an SM each block's 1 KB of reserved shared memory
  static constexpr int FIT = (SMEM_BLOCK / BPS - 1024 - 2 * MAX_STAGES * 8 -
                              64 - (BPS - 1) * 1024) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// wgmma m64nNk16 with A from registers (four bf16 / f16 pairs a thread,
// hopper.cuh's wgmma_rs layout) and B K-major from shared memory, f32
// accumulators (N / 2 a thread); overloaded on the accumulator array
__device__ __forceinline__ void rs_bf16(float (&d)[4], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_bf16(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_bf16(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_bf16(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_f16(float (&d)[4], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_f16(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_f16(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void rs_f16(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


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
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return ptt::pack_bf16(lo, hi);
  }
  template <int R>
  static __device__ __forceinline__ void mma(float (&d)[R],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    rs_bf16(d, a, db, acc);
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
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  template <int R>
  static __device__ __forceinline__ void mma(float (&d)[R],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    rs_f16(d, a, db, acc);
  }
};

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

struct Args {
  const void* a;        // [M, K] of T
  const int8_t* q;      // [K, Nq]
  const float* s;       // (k, n) at (k / group) * s_rs + n * s_cs
  const void* bias;     // [N] of T or null (plain epilogue)
  void* out;            // [M, Nv] of T
  float* part;          // scratch [S][tiles][NP / 4][128] float4, or null
  int* tickets;         // [tiles], zero between launches
  int M, K, Nv, group;  // Nv: output columns
  long long s_rs, s_cs;
  int splits, tiles, row_groups, units, vec;
};

// A unit of a block's work: the split range [zlo, zhi) of column tile
// `tile` for rows [m0, m0 + NP). With scratch one split of the tile
// (split fastest); without, a row group's whole tile (row groups
// fastest, so the blocks of one column tile run together and read its
// int8 bytes from L2 once).
struct Unit {
  int m0, tile, zlo, zhi;
};

__device__ __forceinline__ Unit unit_of(int u, const Args& p, int np) {
  Unit w;
  if (p.part != nullptr) {
    w.m0 = 0;
    w.tile = u / p.splits;
    w.zlo = u % p.splits;
    w.zhi = w.zlo + 1;
  } else {
    w.m0 = (u % p.row_groups) * np;
    w.tile = u / p.row_groups;
    w.zlo = 0;
    w.zhi = p.splits;
  }
  return w;
}

// first K step of split z of KT steps in S splits (plan's `bounds`)
__device__ __forceinline__ int split_start(int z, int KT, int S) {
  return static_cast<int>(static_cast<long long>(z) * KT / S);
}

// Tile column c (0..127: box c / 64, column c % 64) of column tile
// `tile`: its output column (valid below Nv) and its column in q. Plain:
// tile * 128 + c. GU: box 0 holds gate columns tile * 64 + c, box 1 the
// same up columns, Nv on.
template <bool GU>
__device__ __forceinline__ int q_col(int tile, int c, int Nv, int* oc) {
  if (GU) {
    *oc = tile * 64 + (c & 63);
    return (c >> 6) * Nv + *oc;
  }
  *oc = tile * TQ + c;
  return *oc;
}

// ---- producer: warp 8 ---------------------------------------------------
//
// Per step: the two int8 boxes and the activation tile by TMA (lane 0;
// or, without vec, all lanes element by element into the same swizzled
// layouts: int8 box b at b * QBOX, the 16-byte chunk c of row r at c ^ (r
// / 2 % 4); activation row r's chunk c at c ^ (r % 8)), and the 128
// column scales by cp.async (0 past the output's columns), all
// completing on the stage's full-barrier.
template <typename T, bool GU, int NP>
__device__ void produce(const CUtensorMap* map_a, const CUtensorMap* map_q,
                        const Args& p, unsigned char* smem, uint64_t* full,
                        uint64_t* empty, int KT) {
  using G = Geo<NP>;
  const int lane = threadIdx.x & 31;
  const T* A = static_cast<const T*>(p.a);
  const size_t ldq = GU ? 2 * static_cast<size_t>(p.Nv) : p.Nv;
  int st = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(u, p, NP);
    const int k_hi = split_start(w.zhi, KT, p.splits);
    for (int kt = split_start(w.zlo, KT, p.splits); kt < k_hi; ++kt) {
      unsigned char* stage = smem + st * G::STAGE_BYTES;
      hw::mbar_wait(&empty[st], ph ^ 1);
      const int k0 = kt * TK;
      if (p.vec) {
        if (lane == 0) {
          hw::mbar_arrive_expect_tx(&full[st], Q_BYTES + G::A_BYTES);
          const int c0 = GU ? w.tile * 64 : w.tile * TQ;
          hw::tma_load_2d(stage, map_q, &full[st], c0, k0);
          hw::tma_load_2d(stage + QBOX, map_q, &full[st],
                          GU ? p.Nv + c0 : c0 + 64, k0);
          hw::tma_load_2d(stage + Q_BYTES, map_a, &full[st], k0, w.m0);
        }
      } else {
        for (int i = lane; i < TK * TQ; i += 32) {
          const int r = i / TQ, c = i % TQ, cc = c & 63;
          int oc;
          const int qc = q_col<GU>(w.tile, c, p.Nv, &oc);
          stage[(c >> 6) * QBOX + r * 64 +
                (((cc >> 4) ^ ((r >> 1) & 3)) << 4) + (cc & 15)] =
              static_cast<unsigned char>(
                  (k0 + r < p.K && oc < p.Nv) ? p.q[(k0 + r) * ldq + qc] : 0);
        }
        T* at = reinterpret_cast<T*>(stage + Q_BYTES);
        for (int i = lane; i < NP * TK; i += 32) {
          const int r = i / TK, c = i % TK;
          const int gr = w.m0 + r, gk = k0 + c;
          at[r * 64 + (((c >> 3) ^ (r & 7)) << 3) + (c & 7)] =
              (gr < p.M && gk < p.K) ? A[static_cast<size_t>(gr) * p.K + gk]
                                     : Elem<T>::from_f(0.f);
        }
        hw::fence_proxy_async();          // the activations feed wgmma
        __syncwarp();
        if (lane == 0) hw::mbar_arrive(&full[st]);
      }
      float* sc = reinterpret_cast<float*>(stage + Q_BYTES + G::A_BYTES);
      const long long srow = static_cast<long long>(k0 / p.group) * p.s_rs;
#pragma unroll
      for (int j = 0; j < TQ / 32; ++j) {
        const int c = lane + 32 * j;
        int oc;
        const int qc = q_col<GU>(w.tile, c, p.Nv, &oc);
        const bool in = oc < p.Nv;
        hw::cp_async4(sc + c, in ? p.s + srow + qc * p.s_cs : p.s, in ? 4 : 0);
      }
      hw::cp_async_arrive_noinc(&full[st]);
      if (++st == G::STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
  }
}

// ---- consumers: warpgroups 0 and 1 ----------------------------------------------

// One ldmatrix.trans register of int8 codes (bytes: (k, n), (k, n + 1),
// (k + 1, n), (k + 1, n + 1)) -> the A pair of column n + y (y = 0 or 1:
// the warpgroup's column of the pair) at k, k + 1: round_to_T(f32(q) *
// s). f32(q) is exact: the byte (q + 128) placed in the mantissa of 2^23
// is 2^23 + 128 + q.
template <typename T>
__device__ __forceinline__ uint32_t dequant(uint32_t r, float s, int y) {
  const uint32_t b = r ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + y));
  const float hi = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7442 + y));
  return Elem<T>::pack((lo - 8388736.f) * s, (hi - 8388736.f) * s);
}

// True in every consumer thread of the block that arrives last of n at
// `ticket`, after this block's partials were written (the consumers'
// form of paged_split.cuh::ticket_last: named barrier 1 over the two
// consumer warpgroups; the last block resets the ticket).
__device__ __forceinline__ bool ticket_last(int* ticket, int n, int* s_last) {
  __threadfence();
  hw::named_sync(1, 256);
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(ticket, 1);
    *s_last = arrived == n - 1;
    if (*s_last) atomicExch(ticket, 0);
  }
  hw::named_sync(1, 256);
  const bool last = *s_last;
  if (last) __threadfence();
  return last;
}

// Warpgroup y (0 or 1) takes the columns jj + y of both boxes, jj = 16 wq
// + 2 g for warp wq, lane 4 g + c: its product's A row 16 wq + g is box
// 0's column jj + y and row 16 wq + g + 8 box 1's (SwiGLU: the gate and
// up column of one output), so accumulator 4 j + 2 h + e is box h's
// column jj + y at the tile's row m0 + 8 j + 2 c + e. Both warpgroups
// read the same ldmatrix registers and keep their own bytes of them.
template <typename T, bool GU, int NP>
__device__ void consume(const Args& p, unsigned char* smem, uint64_t* full,
                        uint64_t* empty, int KT, int* s_last) {
  using G = Geo<NP>;
  constexpr int R = NP / 2;
  // float4s of one warpgroup's partials: a (split, tile) holds two
  constexpr int SLAB = (R / 4) * 128;
  // j's merged a chunk
  constexpr int JC = R / 4 < 4 ? R / 4 : 4;
  const int y = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int lane = t & 31, wq = t >> 5;
  const int jj = 16 * wq + 2 * (lane >> 2), c2 = 2 * (lane & 3);
  // ldmatrix.x4.trans: lanes 8 i .. 8 i + 7 give the rows of matrix i =
  // (box i / 2, k rows 8 (i % 2) ..), 16 bytes at the warp's columns
  const int lrow = 8 * ((lane >> 3) & 1) + (lane & 7);
  const int lbox = (lane >> 4) * QBOX;
  T* out = static_cast<T*>(p.out);
  const T* bias = static_cast<const T*>(p.bias);
  float acc[R], tot[R];
  uint32_t f[4][4];
  int st = 0, st_prev = 0;
  uint32_t ph = 0;

  // One K step, a wgmma group per k16 slice: slice kk's fragment is
  // rewritten once the previous step's group for kk has retired
  // (wgmma.wait_group 3 leaves the three groups since in flight), so the
  // dequant of each slice overlaps the products of the three before it.
  // The previous step's stage is released once its last group retired.
  auto step = [&](bool first) {
    const unsigned char* stage = smem + st * G::STAGE_BYTES;
    hw::mbar_wait(&full[st], ph);
    const float* sc =
        reinterpret_cast<const float*>(stage + Q_BYTES + G::A_BYTES);
    const float s0 = sc[jj + y], s1 = sc[64 + jj + y];
    const T* at = reinterpret_cast<const T*>(stage + Q_BYTES);
    // the step's codes first: the loads run ahead of the waits below
    uint32_t r[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = 16 * kk + lrow;
      ptt::ldmatrix_x4_trans(
          r[kk], stage + lbox + k * 64 + ((wq ^ ((k >> 1) & 3)) << 4));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hw::wgmma_wait<3>();
      if (kk == 3 && !first && lane == 0) hw::mbar_arrive(&empty[st_prev]);
      f[kk][0] = dequant<T>(r[kk][0], s0, y);
      f[kk][1] = dequant<T>(r[kk][2], s1, y);
      f[kk][2] = dequant<T>(r[kk][1], s0, y);
      f[kk][3] = dequant<T>(r[kk][3], s1, y);
      hw::fence_regs(acc);
      hw::wgmma_fence();
      Elem<T>::mma(acc, f[kk], hw::desc_sw128(at + kk * 16, 16, 1024),
                   !first || kk > 0);
      hw::wgmma_commit();
      hw::fence_regs(acc);
    }
    st_prev = st;
    if (++st == G::STAGES) {
      st = 0;
      ph ^= 1;
    }
  };

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const Unit w = unit_of(u, p, NP);
    for (int z = w.zlo; z < w.zhi; ++z) {
      const int k_lo = split_start(z, KT, p.splits);
      const int k_hi = split_start(z + 1, KT, p.splits);
      for (int kt = k_lo; kt < k_hi; ++kt) step(kt == k_lo);
      hw::wgmma_wait<0>();
      hw::fence_regs(acc);
      if (lane == 0) hw::mbar_arrive(&empty[st_prev]);
      // a block that owns several splits: each split's fresh sums added
      // to the running total in split order. Only wgmma defines the
      // accumulators: another definition would make ptxas serialise the
      // products (its warning C7515).
      if (w.zhi - w.zlo > 1) {
#pragma unroll
        for (int i = 0; i < R; ++i) tot[i] = z > w.zlo ? tot[i] + acc[i] : acc[i];
      }
    }

    float4* slab = reinterpret_cast<float4*>(p.part) + t;
    if (p.part != nullptr) {
      // one split of the tile: leave the partial ([split][tile][warpgroup]
      // [float4 j][thread], so the stores and the merge's loads are whole
      // 512-byte rows); the last block of the tile merges
      float4* mine =
          slab + ((static_cast<size_t>(w.zlo) * p.tiles + w.tile) * 2 + y) *
                     SLAB;
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
        mine[j * 128] = make_float4(acc[4 * j], acc[4 * j + 1],
                                    acc[4 * j + 2], acc[4 * j + 3]);
      if (!ticket_last(&p.tickets[w.tile], p.splits, s_last)) continue;
    }

    // epilogue: rows m0 + 8 j + 2 c + e; (v.x, v.y) box 0's column jj + y
    // at e = 0, 1, (v.z, v.w) box 1's
    auto emit = [&](int j, float4 v) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = w.m0 + 8 * j + c2 + e;
        if (m >= p.M) continue;
        const float x0 = e ? v.y : v.x, x1 = e ? v.w : v.z;
        T* orow = out + static_cast<size_t>(m) * p.Nv;
        if constexpr (GU) {
          const int col = w.tile * 64 + jj + y;
          if (col < p.Nv) orow[col] = Elem<T>::from_f(silu_mul(x0, x1));
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = w.tile * TQ + 64 * h + jj + y;
            if (col >= p.Nv) continue;
            T o = Elem<T>::from_f(h ? x1 : x0);
            if (bias != nullptr)
              o = Elem<T>::from_f(Elem<T>::to_f(o) + Elem<T>::to_f(bias[col]));
            orow[col] = o;
          }
        }
      }
    };
    if (p.part != nullptr) {
      // JC j's at a time: every split's float4s of them loaded at once
      // (one trip to L2 a chunk), then added in split order
#pragma unroll
      for (int j0 = 0; j0 < R / 4; j0 += JC) {
        float4 v[MAX_SPLITS][JC];
#pragma unroll
        for (int z = 0; z < MAX_SPLITS; ++z)
          if (z < p.splits)
#pragma unroll
            for (int jc = 0; jc < JC; ++jc)
              v[z][jc] = __ldcg(
                  slab +
                  ((static_cast<size_t>(z) * p.tiles + w.tile) * 2 + y) *
                      SLAB +
                  (j0 + jc) * 128);
#pragma unroll
        for (int z = 1; z < MAX_SPLITS; ++z)
          if (z < p.splits)
#pragma unroll
            for (int jc = 0; jc < JC; ++jc) add4(v[0][jc], v[z][jc]);
#pragma unroll
        for (int jc = 0; jc < JC; ++jc) emit(j0 + jc, v[0][jc]);
      }
    } else if (w.zhi - w.zlo > 1) {
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
        emit(j, make_float4(tot[4 * j], tot[4 * j + 1], tot[4 * j + 2],
                            tot[4 * j + 3]));
    } else {
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
        emit(j, make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                            acc[4 * j + 3]));
    }
  }
}

template <typename T, bool GU, int NP>
__global__ void __launch_bounds__(Geo<NP>::THREADS, Geo<NP>::BPS)
w8a16_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_q, const Args p) {
  using G = Geo<NP>;
  extern __shared__ __align__(128) unsigned char wq_smem[];
  __shared__ int s_last;
  unsigned char* smem =
      wq_smem + ((1024 - (hw::smem_u32(wq_smem) & 1023)) & 1023);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int KT = (p.K + TK - 1) / TK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < G::STAGES; ++st) {
      // the TMA thread's arrival (or the element-wise warp's) and the
      // producer lanes' 32 cp.async arrivals
      hw::mbar_init(&full[st], 33);
      hw::mbar_init(&empty[st], 8);        // one arrival per consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    // the producer: warp 8 loads (the rest of its warpgroup leaves)
    if constexpr (G::BPS == 1) hw::setmaxnreg_dec<40>();
    if (threadIdx.x < 288)
      produce<T, GU, NP>(&map_a, &map_q, p, smem, full, empty, KT);
  } else {
    if constexpr (G::BPS == 1) hw::setmaxnreg_inc<232>();
    consume<T, GU, NP>(p, smem, full, empty, KT, &s_last);
  }
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Tensor maps by (kind, base, rows, columns, box rows): a map depends on
// nothing else, so each weight's and each recurring activation buffer's
// is encoded once (an encode costs the host microseconds a launch).
struct MapSlot {
  CUtensorMap map;
  const void* base;
  uint64_t rows, cols;
  uint32_t box, kind;
  bool used;
};
constexpr int MAP_SLOTS = 512;
MapSlot g_maps[MAP_SLOTS];
std::mutex g_maps_mu;

int tensor_map(CUtensorMap* out, uint32_t kind, const void* base,
               uint64_t rows, uint64_t cols, uint32_t box) {
  uint64_t h = reinterpret_cast<uintptr_t>(base) >> 4;
  h = (h ^ (rows * 0x9E3779B97F4A7C15ull) ^ (cols << 20) ^ (box << 8) ^
       kind) * 0xBF58476D1CE4E5B9ull;
  MapSlot& e = g_maps[(h >> 40) % MAP_SLOTS];
  std::lock_guard<std::mutex> lock(g_maps_mu);
  if (!(e.used && e.base == base && e.rows == rows && e.cols == cols &&
        e.box == box && e.kind == kind)) {
    e.used = false;
    const int err = kind == 0 ? hw::tma_map_bf16(&e.map, base, rows, cols, box)
                              : hw::tma_map_u8_sw64(&e.map, base, rows, cols,
                                                    box);
    if (err != 0) return err;
    e.base = base;
    e.rows = rows;
    e.cols = cols;
    e.box = box;
    e.kind = kind;
    e.used = true;
  }
  *out = e.map;
  return 0;
}

template <typename T, bool GU, int NP>
int launch_np(const Args& p, int grid, cudaStream_t stream) {
  using G = Geo<NP>;
  CUtensorMap map_a, map_q;
  memset(&map_a, 0, sizeof(map_a));
  memset(&map_q, 0, sizeof(map_q));
  if (p.vec) {
    // f16 rows move as the same 2-byte elements
    int err = tensor_map(&map_a, 0, p.a, p.M, p.K, NP);
    if (err != 0) return err;
    err = tensor_map(&map_q, 1, p.q, p.K, GU ? 2LL * p.Nv : p.Nv, 64);
    if (err != 0) return err;
  }
  auto kernel = w8a16_kernel<T, GU, NP>;
  // the shared-memory opt-in, once per device
  static unsigned opted = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= 32 || !((opted >> device) & 1u)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device < 32) opted |= 1u << device;
  }
  const int blocks = grid < p.units ? grid : p.units;
  kernel<<<blocks, G::THREADS, G::SMEM, stream>>>(map_a, map_q, p);
  return static_cast<int>(cudaGetLastError());
}

// Nv: output columns (plain: q's N; SwiGLU: Mh, q being [K, 2 Mh]).
// splits, np (the row group and the products' N: 8, 32, 64 or 128),
// grid, tickets and part come from the wrapper's `plan`: part null for
// one split or above 128 rows.
template <typename T, bool GU>
int w8a16_launch(const void* a, const void* q, const void* s, const void* bias,
                 void* out, int M, int K, int Nv, int group, long long s_rs,
                 long long s_cs, int splits, int np, int grid, void* tickets,
                 void* part, cudaStream_t stream) {
  if (M <= 0 || Nv <= 0) return static_cast<int>(cudaSuccess);
  const int KT = (K + TK - 1) / TK;
  if (K <= 0 || group <= 0 || (s_rs != 0 && group % TK != 0) ||
      splits < 1 || splits > KT || splits > MAX_SPLITS || grid < 1 ||
      (part != nullptr && (M > np || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.a = a;
  p.q = static_cast<const int8_t*>(q);
  p.s = static_cast<const float*>(s);
  p.bias = bias;
  p.out = out;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.M = M;
  p.K = K;
  p.Nv = Nv;
  p.group = group;
  p.s_rs = s_rs;
  p.s_cs = s_cs;
  p.splits = splits;
  p.tiles = GU ? (Nv + 63) / 64 : (Nv + TQ - 1) / TQ;
  p.row_groups = (M + np - 1) / np;
  p.units = part != nullptr ? p.tiles * splits : p.tiles * p.row_groups;
  p.vec = K % 8 == 0 && (GU ? 2LL * Nv : Nv) % 16 == 0 && aligned16(a) &&
          aligned16(q);
  switch (np) {
    case 8: return launch_np<T, GU, 8>(p, grid, stream);
    case 32: return launch_np<T, GU, 32>(p, grid, stream);
    case 64: return launch_np<T, GU, 64>(p, grid, stream);
    case 128: return launch_np<T, GU, 128>(p, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The geometry a C entry reads from host memory, from the wrapper's
// `plan`: M, K, output columns (plain: q's N; SwiGLU: Mh, q being [K,
// 2 Mh]), the scale's group and its strides (element (k, n) at (k /
// group) * s_rs + n * s_cs), S, the products' N and the grid. One
// pointer instead of nine arguments keeps the host's enqueue short.
enum { G_M, G_K, G_NV, G_GROUP, G_SRS, G_SCS, G_SPLITS, G_NP, G_GRID };

template <typename T, bool GU>
int w8a16_entry(const void* a, const void* q, const void* s, const void* bias,
                void* out, const long long* g, void* tickets, void* part,
                void* stream) {
  return w8a16_launch<T, GU>(
      a, q, s, bias, out, static_cast<int>(g[G_M]), static_cast<int>(g[G_K]),
      static_cast<int>(g[G_NV]), static_cast<int>(g[G_GROUP]), g[G_SRS],
      g[G_SCS], static_cast<int>(g[G_SPLITS]), static_cast<int>(g[G_NP]),
      static_cast<int>(g[G_GRID]), tickets, part,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// a [M, K], q int8 [K, N], s f32, bias [N] or null, out [M, N]; the
// geometry above, tickets and the f32 scratch (or null) from `plan`
extern "C" int ptt_weight_only_linear_bf16(const void* a, const void* q,
                                           const void* s, const void* bias,
                                           void* out, const long long* geo,
                                           void* tickets, void* part,
                                           void* stream) {
  return w8a16_entry<bf16, false>(a, q, s, bias, out, geo, tickets, part,
                                  stream);
}

extern "C" int ptt_weight_only_linear_f16(const void* a, const void* q,
                                          const void* s, const void* bias,
                                          void* out, const long long* geo,
                                          void* tickets, void* part,
                                          void* stream) {
  return w8a16_entry<__half, false>(a, q, s, bias, out, geo, tickets, part,
                                    stream);
}

// a [M, K], q int8 [K, 2 Mh] = [Qg | Qu], s as above over the 2 Mh
// columns, out [M, Mh] = silu(a @ deq(Qg)) * (a @ deq(Qu))
extern "C" int ptt_weight_only_swiglu_bf16(const void* a, const void* q,
                                           const void* s, void* out,
                                           const long long* geo,
                                           void* tickets, void* part,
                                           void* stream) {
  return w8a16_entry<bf16, true>(a, q, s, nullptr, out, geo, tickets, part,
                                 stream);
}

extern "C" int ptt_weight_only_swiglu_f16(const void* a, const void* q,
                                          const void* s, void* out,
                                          const long long* geo,
                                          void* tickets, void* part,
                                          void* stream) {
  return w8a16_entry<__half, true>(a, q, s, nullptr, out, geo, tickets, part,
                                   stream);
}

