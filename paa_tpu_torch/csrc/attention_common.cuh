// Shared pieces of the attention kernels (attention_fwd.cu, attention_bwd.cu).
//
// Tiles live in shared memory. Products of two shared tiles go through
// block_gemm: for bfloat16 it runs the tensor cores through WMMA
// (16x16x16, f32 accumulation), for float32 it runs plain FMA loops so
// that float32 results stay exact float32 (the tiny preset, the tests).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace paa {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 128;  // 4 warps per block
constexpr int kWarps = kThreads / 32;
constexpr float kMaskScore = -1e30f;  // score of a padded key, as on the TPU

// Row strides of the shared tiles, padded against bank conflicts. Every
// stride is a multiple of 16 bytes (WMMA's ldm rule) and every 16-row
// offset a multiple of 32 bytes (WMMA's pointer alignment rule).
template <typename T, int D>
__host__ __device__ constexpr int ld_in() { return D + 8; }  // T-typed [rows][D]
__host__ __device__ constexpr int ld_score() { return kBK + 4; }  // f32 [rows][BK]
template <typename T>
__host__ __device__ constexpr int ld_prob() { return kBK + 8; }  // T-typed [rows][BK]
template <int D>
__host__ __device__ constexpr int ld_acc() { return D + 4; }  // f32 [rows][D]

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// Copy rows [row0, row0 + ROWS) of a (n_rows, row_stride) global array,
// D elements from `src` on, into a [ROWS][ld] shared tile; rows at or past
// n_rows become zero. 16-byte vectors; the wrapper checks the alignment.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src,
                                          long row_stride, int row0, int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Store rows [0, ROWS) of an f32 [ROWS][ld] shared tile, scaled per row by
// row_scale (or 1), to a (n_rows, row_stride) global array of T; rows at or
// past n_rows are not stored.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long row_stride, int row0,
                                           int n_rows, const float* acc, int ld,
                                           const float* row_scale) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    if (row0 + r < n_rows) {
      const float s = row_scale ? row_scale[r] : 1.0f;
      dst[(row0 + r) * row_stride + c] = from_f<T>(acc[r * ld + c] * s);
    }
  }
}

struct RowMajor {};
struct ColMajor {};

// C[M][N] (+)= A·B over shared tiles. A(m, k) is a[m*lda + k] (RowMajor) or
// a[k*lda + m] (ColMajor); B(k, n) is b[k*ldb + n] (RowMajor) or
// b[n*ldb + k] (ColMajor); C is f32 row-major with ldc. M, N and K are
// multiples of 16. The caller synchronises before and after.
template <typename T, typename LA, typename LB, int M, int N, int K>
__device__ __forceinline__ void block_gemm(float* C, int ldc, const T* A, int lda, const T* B,
                                           int ldb, bool accumulate) {
  constexpr bool kRowA = std::is_same<LA, RowMajor>::value;
  constexpr bool kRowB = std::is_same<LB, RowMajor>::value;
  if constexpr (std::is_same<T, bf16>::value) {
    namespace wmma = nvcuda::wmma;
    using la = typename std::conditional<kRowA, wmma::row_major, wmma::col_major>::type;
    using lb = typename std::conditional<kRowB, wmma::row_major, wmma::col_major>::type;
    constexpr int kTilesN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int tile = warp; tile < (M / 16) * kTilesN; tile += kWarps) {
      const int tm = (tile / kTilesN) * 16;
      const int tn = (tile % kTilesN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      float* cptr = C + tm * ldc + tn;
      if (accumulate) {
        wmma::load_matrix_sync(c, cptr, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, la> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, lb> b;
        wmma::load_matrix_sync(a, kRowA ? A + tm * lda + kk : A + kk * lda + tm, lda);
        wmma::load_matrix_sync(b, kRowB ? B + kk * ldb + tn : B + tn * ldb + kk, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(cptr, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N;
      const int n = idx % N;
      float acc = accumulate ? C[m * ldc + n] : 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = to_f<T>(kRowA ? A[m * lda + k] : A[k * lda + m]);
        const float b = to_f<T>(kRowB ? B[k * ldb + n] : B[n * ldb + k]);
        acc = fmaf(a, b, acc);
      }
      C[m * ldc + n] = acc;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace paa
