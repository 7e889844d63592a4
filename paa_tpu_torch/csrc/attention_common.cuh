// Shared pieces of the register-route attention kernels (attention_fwd.cu,
// attention_bwd.cu): float32 with head dim 16 or 64, and bfloat16 with head
// dim 16. No score, probability or output tile lives in shared memory:
// shared memory holds only the rows that are streamed past the rows a block
// owns (K and V, or Q and dO with their rows' lse and D), a tile at a time.
//
// float32 runs on the FMA units in exact float32 (no TF32). The rows a block
// owns belong to row groups of GD·GS adjacent lanes: GD lanes split the head
// dim, GS lanes split the streamed rows, and each group owns R rows. Each
// lane keeps its slice of its rows' operands and accumulators in registers
// and reads a streamed row's slice from shared memory once, as 16-byte
// vectors that the lanes of the same split share as broadcasts, for all R
// rows.
//
// bfloat16 runs on the tensor cores through mma.sync.m16n8k16 (bf16
// inputs, f32 accumulation) with every fragment in registers: a warp owns
// 16 rows, loads its A operands straight from device memory, takes the
// streamed tile's B operands from shared memory with ldmatrix, and reuses
// the f32 accumulators of one product, rounded to bf16, as the A operand of
// the next (the probabilities and the score gradients never leave
// registers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace paa {

using bf16 = __nv_bfloat16;

constexpr float kMaskScore = -1e30f;  // score of a padded key, as on the TPU
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockRows = 32;  // rows a block owns (queries, or keys in the dk/dv role)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

// exp(x − m) through the ex2 unit
__device__ __forceinline__ float exp_sub(float x, float m) { return exp2f((x - m) * kLog2e); }

// D = Σ_c do[c]·o[c] over one row, in column order. Every kernel that needs a
// row's D computes it with this function, so the two roles of the backward
// agree to the bit.
template <typename T, int D>
__device__ __forceinline__ float row_delta(const T* __restrict__ dout, const T* __restrict__ o) {
  constexpr int kVec = 16 / sizeof(T);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D; c += kVec) {
    const uint4 a = *reinterpret_cast<const uint4*>(dout + c);
    const uint4 b = *reinterpret_cast<const uint4*>(o + c);
    const T* x = reinterpret_cast<const T*>(&a);
    const T* y = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc = fmaf(to_f<T>(x[i]), to_f<T>(y[i]), acc);
  }
  return acc;
}

// Copy rows [row0, row0 + ROWS) of a (n_rows, row_stride) array, D elements
// from `src` on, into a [ROWS][LD] shared tile; rows at or past n_rows become
// zero. 16-byte vectors; the wrapper checks the alignment.
template <typename T, int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src, long row_stride,
                                           int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += NT) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// ---------------------------------------------------------------------------
// float32: row groups
// ---------------------------------------------------------------------------

// A block of kThreads lanes owns kBlockRows rows of one head. kLanes = GD·GS
// adjacent lanes form a row group, which owns R rows: group g of the block
// owns rows g, g + kGroups, ... . Lane t: group t / kLanes, split
// (t / GD) % GS, dim slice t % GD. Slice d holds the float4 columns c·GD + d,
// c < kV4, of each of its rows: neighbouring slices read neighbouring 16
// bytes of a shared row. A streamed tile is kTile rows; split s takes its
// rows s, s + GS, ..., kPer of them, and uses each for all its R rows (and,
// in the backward's key role, for both products a row takes part in), so
// that a float read from shared memory feeds several FMAs: an SM moves 32
// floats a cycle from shared memory to its 128 FMA lanes.
template <int D, int GD_, int GS_, int R_, int PER, int MIN_BLOCKS = 1>
struct RowGroups {
  static constexpr int kMinBlocks = MIN_BLOCKS;  // blocks an SM must hold (caps registers)
  static constexpr int GD = GD_;
  static constexpr int GS = GS_;
  static constexpr int R = R_;
  static constexpr int kLanes = GD * GS;
  static constexpr int kGroups = kBlockRows / R;
  static constexpr int kThreads = kGroups * kLanes;
  static constexpr int kV4 = D / (4 * GD);  // float4 a lane holds of a row
  static constexpr int kPer = PER;          // streamed rows a lane takes a tile
  static constexpr int kTile = kPer * GS;
  static constexpr int kLd = D + 8;  // shared row stride (floats): the GS·GD addresses a
                                     // broadcast read touches fall in distinct banks
};

// d = 16, both kernels: 4 lanes split the keys (or queries) and each holds
// its 2 rows whole (64 threads, tiles of 64).
// d = 64, forward: 2 lanes split the dims and 2 the keys, one row a group
// (128 threads, tiles of 32), at most 128 registers so that 4 blocks fit an
// SM: at base's shape on the H100 the forward ran slower both in the
// backward's shape (4 dim lanes, 2 rows a group) and at 136 registers.
// d = 64, backward: 4 lanes split the dims, 2 rows a group (64 threads,
// tiles of 32): a quarter of k, v, dk and dv of 2 rows is 128 registers.
template <int D>
using FwdRows =
    std::conditional_t<D == 64, RowGroups<64, 2, 2, 1, 16, 4>, RowGroups<D, 1, 4, 2, 16>>;
template <int D>
using BwdRows = std::conditional_t<D == 64, RowGroups<64, 4, 1, 2, 32>, RowGroups<D, 1, 4, 2, 16>>;

template <int GD>
__device__ __forceinline__ float sum_dims(float v) {  // over the row's GD dim slices
#pragma unroll
  for (int off = 1; off < GD; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Butterflies over the row's GS splits: every lane ends with the same bits
// (a + b = b + a), in an order fixed by the lane layout.
template <int GD, int GS>
__device__ __forceinline__ float max_splits(float v) {
#pragma unroll
  for (int off = GD; off < GD * GS; off <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int GD, int GS>
__device__ __forceinline__ float sum_splits(float v) {
#pragma unroll
  for (int off = GD; off < GD * GS; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int GD, int GS, int V4>
__device__ __forceinline__ void sum_splits(float4 (&x)[V4]) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    x[c].x = sum_splits<GD, GS>(x[c].x);
    x[c].y = sum_splits<GD, GS>(x[c].y);
    x[c].z = sum_splits<GD, GS>(x[c].z);
    x[c].w = sum_splits<GD, GS>(x[c].w);
  }
}

// A lane's slice of one row (zeros for a null row), from device or shared
// memory.
template <int GD, int V4>
__device__ __forceinline__ void load_slice(float4 (&x)[V4], const float* row, int d) {
#pragma unroll
  for (int c = 0; c < V4; ++c)
    x[c] = row ? *reinterpret_cast<const float4*>(row + 4 * (c * GD + d)) : make_float4(0, 0, 0, 0);
}

template <int GD, int V4>
__device__ __forceinline__ void store_slice(float* __restrict__ row, const float4 (&x)[V4],
                                            float scale, int d) {
#pragma unroll
  for (int c = 0; c < V4; ++c)
    *reinterpret_cast<float4*>(row + 4 * (c * GD + d)) =
        make_float4(x[c].x * scale, x[c].y * scale, x[c].z * scale, x[c].w * scale);
}

// Σ over the lane's slice of x · (a shared row), and acc += a · (the lane's
// slice of a shared row). The callers apply them to the same shared row for
// each of their rows, with no store between, so the compiler loads it once.
template <int GD, int V4>
__device__ __forceinline__ float dot_shared(const float4 (&x)[V4], const float* srow, int d) {
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (c * GD + d));
    acc = fmaf(x[c].x, y.x, acc);
    acc = fmaf(x[c].y, y.y, acc);
    acc = fmaf(x[c].z, y.z, acc);
    acc = fmaf(x[c].w, y.w, acc);
  }
  return acc;
}

template <int GD, int V4>
__device__ __forceinline__ void axpy_shared(float4 (&acc)[V4], float a, const float* srow, int d) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    const float4 y = *reinterpret_cast<const float4*>(srow + 4 * (c * GD + d));
    acc[c].x = fmaf(a, y.x, acc[c].x);
    acc[c].y = fmaf(a, y.y, acc[c].y);
    acc[c].z = fmaf(a, y.z, acc[c].z);
    acc[c].w = fmaf(a, y.w, acc[c].w);
  }
}

template <int V4>
__device__ __forceinline__ void scale_slice(float4 (&acc)[V4], float a) {
#pragma unroll
  for (int c = 0; c < V4; ++c) {
    acc[c].x *= a;
    acc[c].y *= a;
    acc[c].z *= a;
    acc[c].w *= a;
  }
}

template <int V4>
__device__ __forceinline__ void zero_slice(float4 (&acc)[V4]) {
#pragma unroll
  for (int c = 0; c < V4; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// bfloat16, head dim 16: mma.sync fragments
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = kBlockRows / 16;  // 2 warps, 16 rows each
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaTile = 64;                // streamed rows a tile
constexpr int kMmaLd = 24;  // shared row stride (bf16): 48 bytes, so the 8 rows of an
                            // ldmatrix 8x8 fall in distinct banks

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A operand (16 rows × 16 dims, row-major) of rows [row0, row0 + 16) of a
// (n_rows, row_stride) bf16 array, straight from device memory; rows at or
// past n_rows are zero. Lane l holds rows row0 + l/4 (+8), columns
// 2(l%4) (+1, +8, +9).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* __restrict__ src,
                                       long row_stride, int row0, int n_rows, int lane) {
  const int r = row0 + lane / 4;
  const int c = 2 * (lane % 4);
  auto at = [&](int row, int col) -> uint32_t {
    return row < n_rows ? *reinterpret_cast<const uint32_t*>(src + row * row_stride + col) : 0u;
  };
  a[0] = at(r, c);
  a[1] = at(r + 8, c);
  a[2] = at(r, c + 8);
  a[3] = at(r + 8, c + 8);
}

// B operands from 16 rows [g0, g0 + 16) of a [rows][kMmaLd] shared tile.
// b_rows_n: the rows are the product's n (A·tileᵀ): b[0], b[1] for rows
//   g0..g0+7, b[2], b[3] for rows g0+8..g0+15.
// b_rows_k: the rows are the product's k (A·tile): b[0], b[1] for dims 0-7,
//   b[2], b[3] for dims 8-15.
__device__ __forceinline__ void b_rows_n(uint32_t (&b)[4], const bf16* tile, int g0, int lane) {
  const bf16* p = tile + (g0 + lane % 8 + (lane / 16) * 8) * kMmaLd + ((lane / 8) % 2) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

__device__ __forceinline__ void b_rows_k(uint32_t (&b)[4], const bf16* tile, int g0, int lane) {
  const bf16* p = tile + (g0 + lane % 8 + ((lane / 8) % 2) * 8) * kMmaLd + (lane / 16) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// c (16×8 f32) += a (16×16 bf16) · b (16×8 bf16). Lane l holds c at rows l/4
// (c[0], c[1]) and l/4 + 8 (c[2], c[3]), columns 2(l%4) and 2(l%4) + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 16×8 f32 accumulators over 16 consecutive columns, rounded to bf16, as
// the A operand (16×16) of the next product: the layouts coincide.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Two 16×8 accumulators (dims 0-7, 8-15) of rows row0 + l/4 (+8), scaled per
// row, stored as bf16 to a (n_rows, row_stride) array.
__device__ __forceinline__ void store_acc(bf16* __restrict__ dst, long row_stride, int row0,
                                          int n_rows, const float (&acc)[2][4], float scale_a,
                                          float scale_b, int lane) {
  const int r = row0 + lane / 4;
  const int c = 2 * (lane % 4);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (r < n_rows)
      *reinterpret_cast<uint32_t*>(dst + r * row_stride + 8 * t + c) =
          pack_bf16(acc[t][0] * scale_a, acc[t][1] * scale_a);
    if (r + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(dst + (r + 8) * row_stride + 8 * t + c) =
          pack_bf16(acc[t][2] * scale_b, acc[t][3] * scale_b);
  }
}

__device__ __forceinline__ float quad_max(float v) {  // over the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

}  // namespace paa
