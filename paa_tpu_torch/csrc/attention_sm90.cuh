// Hopper building blocks of the bf16, head-dim-64 attention kernels
// (attention_fwd_sm90.cu, attention_bwd_sm90.cu): TMA loads through 3-D
// tensor maps, mbarrier rings, wgmma with 128-byte-swizzled shared operands
// and register accumulators. sm_90a only.
//
// Layouts. A tile of R rows of one head is R × 64 bf16 = R × 128 bytes, as
// TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B: row r at byte 128·r, its
// 16-byte chunks permuted by (r mod 8). Tiles start on 1024-byte
// boundaries. For wgmma such a tile is
//   - K-major (d contiguous) when d is the reduced dimension (q·kᵀ, do·vᵀ):
//     the k-step kk of 16 elements starts 32·kk bytes into the tile;
//   - MN-major (the transpose bit) when the rows are the reduced dimension
//     (p·v, pᵀ·do, dsᵀ·q, ds·k): the k-step kk starts at row 16·kk.
// Either way the stride between groups of 8 rows is 1024 bytes.
//
// The f32 accumulator of an m64nN wgmma gives thread t of the warpgroup
// (warp w = t / 32, lane l) the values i = 0 … N/2 − 1 at
//   row 16·w + l/4 + 8·((i/2) mod 2),  column 8·(i/4) + 2·(l mod 4) + (i mod 2),
// and the register A operand of an m64nNk16 wgmma takes the same rows and,
// for k-step kk, the columns 16·kk … 16·kk + 15 of such an accumulator, so
// that a score tile becomes the next product's A operand in registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace paa {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                 // head dim of this route
constexpr int kRowBytes = kD * 2;      // one bf16 row, = the swizzle span
constexpr int kConsumers = 256;        // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Block until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and tell the barrier to wait for `bytes` more of TMA traffic.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// ---- TMA -----------------------------------------------------------------

// Box (64, rows, 1) of a (H·64, T, B) tensor map at (c0, c1, c2) into dst;
// rows past T arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte-aligned global memory into dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Descriptor of a 128-byte-swizzled shared operand starting at `p`:
// 8-row groups 1024 bytes apart (both offset fields; the one a layout does
// not use is ignored), swizzle mode 1 (128 B).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{64} << 16) | (uint64_t{64} << 32) |
         (uint64_t{1} << 62);
}

// Byte offsets, in a descriptor's 16-byte units, of k-step kk.
__device__ __forceinline__ uint64_t kstep_kmajor(int kk) { return 2 * kk; }     // 32 B
__device__ __forceinline__ uint64_t kstep_mnmajor(int kk) { return 128 * kk; }  // 16 rows

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// After wgmma_wait_all: registers an in-flight wgmma read or wrote are
// neither read early nor reused early by the compiler.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---- the consumers' ping-pong ----------------------------------------------

// The two consumer warpgroups take turns to issue their wgmma: a warpgroup
// issues a group of products only after the other has issued its previous
// group (named barriers 1 and 2, 256 threads). They would otherwise reach
// each tile together, run their products together and then their
// elementwise work (exp2, ds) together, leaving the tensor cores idle in
// between; taking turns keeps one warpgroup's elementwise work beside the
// other's products. Both warpgroups issue the same number of groups; the
// last group's pass is the `last` one. The backward kernels (and K8's
// three, attention_relpos_sm90.cu) use it
// (tools/attention_variants.py times them without it); K1, whose loop is
// software-pipelined, did not gain from it and does not use it.
struct PingPong {
  int wg;  // 0 or 1

  // Before the first group: warpgroup 0 goes first.
  __device__ __forceinline__ void start() const {
    if (wg == 1) arrive(1);
  }
  // Before issuing a group.
  __device__ __forceinline__ void wait_turn() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
  }
  // After issuing a group (and before waiting for it).
  __device__ __forceinline__ void pass(bool last) const {
    if (!(wg == 1 && last)) arrive(2 - wg);
  }

 private:
  __device__ __forceinline__ static void arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kConsumers) : "memory");
  }
};

// Two f32 values as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Columns 16·kk … 16·kk + 15 of an f32 accumulator as the register A
// operand of k-step kk, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// D[64][64] (+)= A[64][16]·B[16][64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64][128] (+)= A[64][16]·B[16][128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64][64] += A[64][16]·B[16][64]; A in registers (four bf16x2 per thread),
// B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// ---- the backward's row statistics (K2 and K8) ------------------------------

// Rows of the backward's scratch arrays (D and lse·log2 e) are padded to a
// multiple of this, so that every query tile of a gradient kernel lies
// inside them.
constexpr int kRowPad = 128;
constexpr int kWarpsPrep = 8;

namespace {

// D = rowsum(do ∘ o) and lse·log2 e of row (b, h, t) for t < Tpad: 8
// threads per row, each reading 16 bytes of do and of o; padded rows get
// D = 0 and lse·log2 e = +∞, so that their p is exactly 0 without a mask.
__global__ void __launch_bounds__(32 * kWarpsPrep)
attn_bwd_prep_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     float* __restrict__ lse2, int B, int T_len, int H, int Tpad) {
  const long row = (static_cast<long>(blockIdx.x) * 32 * kWarpsPrep + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  const bool in_range = row < static_cast<long>(B) * H * Tpad;
  const int t = static_cast<int>(row % Tpad);
  const long bh = row / Tpad;
  float acc = 0.0f;
  if (in_range && t < T_len) {
    const int h = static_cast<int>(bh % H);
    const long b = bh / H;
    const long off = ((b * T_len + t) * H + h) * kD + 8 * part;
    const uint4 x = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 y = *reinterpret_cast<const uint4*>(o + off);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(x2[e]);
      const float2 c = __bfloat1622float2(y2[e]);
      acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
    }
  }
#pragma unroll
  for (int s = 4; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (in_range && part == 0) {
    delta[row] = acc;
    lse2[row] = t < T_len ? lse[bh * T_len + t] * kLog2e : INFINITY;
  }
}

// Launch the kernel above over (B, H, Tpad) rows: delta and lse2 are the
// two halves of the backward's float32 scratch.
inline cudaError_t launch_bwd_prep(const void* o, const void* dout, const void* lse, float* delta,
                                   float* lse2, int B, int T_len, int H, int Tpad,
                                   cudaStream_t st) {
  const long rows = static_cast<long>(B) * H * Tpad;  // 4·kWarpsPrep rows per block
  attn_bwd_prep_kernel<<<static_cast<unsigned>((rows + 4 * kWarpsPrep - 1) / (4 * kWarpsPrep)),
                         32 * kWarpsPrep, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      delta, lse2, B, T_len, H, Tpad);
  return cudaGetLastError();
}

}  // namespace

// ---- host ----------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one (B, T, H·64) bf16 operand: dims (H·64, T, B), box
// (64, rows, 1) at coordinates (h·64, t0, b), 128-byte swizzle, zero fill
// past T (so a box never reads into the next clip). False if refused.
inline bool encode_map(CUtensorMap* map, const void* ptr, int B, int T_len, int H, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H) * kD, static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * kRowBytes,
                                 static_cast<cuuint64_t>(T_len) * H * kRowBytes};
  const cuuint32_t box[3] = {kD, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace sm90
}  // namespace paa
