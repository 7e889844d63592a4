// K3 — Fletcher-Munson weighted power sum on Hopper, one launch.
//
// Replaces paa_tpu/ops/pallas/fm_norm.py:_kernel (launched by
// fm_weighted_power_sum): Σ w·(re² + im²) over the cells of a complex64
// STFT (B, F, T), with SPL = 10·log10(power + 1e-10), w the lerp of the
// (10, F) ISO-226 table along the phon axis at SPL/10, and w = 1 where SPL
// lies outside [0, 90] or the bin outside [20, 20000] Hz. The square root is
// taken outside.
//
// What bounds it on the H100: one read of 8 bytes per cell and a few dozen
// operations. At the main path's (1, 513, 626) that is 2.6 MB, 0.77 µs at
// 3.35 TB/s: the launch, the fill of the card and the cross-block sum bound
// it, not bandwidth.
//
// Design:
//   - The STFT is read where it lies, at the strides it comes with (counted
//     in complex elements). torch.stft gives bins innermost in memory
//     (strides (F·T, 1, F)). When the cells fill one dense block of memory
//     in any order of the three axes (torch.stft's layout and the
//     contiguous one both do), the kernel walks that block flat with
//     16-byte loads (two cells a thread), so a warp reads 512 contiguous
//     bytes; a cell's bin is (offset / bin stride) mod F. Any other layout
//     takes a walk cell by cell through the strides.
//   - Each block stages the (10, F) table and the (F,) domain mask in
//     shared memory (22.6 KB at F = 513) while its first loads of the STFT
//     are in flight, every load of a thread issued before its first store.
//   - One launch, one block per SM, striding over the cells. Each thread
//     sums its cells in a fixed order, each block reduces by warp shuffles
//     then shared memory and writes its partial; the block that takes the
//     last ticket (an integer acquire-release atomic) sums the partials in
//     index order with one warp and sets the ticket back to 0. No float
//     atomics: the bits repeat from call to call. (Two full fences around
//     atomicInc cost 0.5 µs more a call on the H100.)
// The lerp is written as the gather the plain version uses; with the phon
// grid at 0, 10, ..., 90 it equals the TPU kernel's sum of hat functions.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cuda/atomic>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBatch = 4;   // 16-byte loads of the STFT a thread keeps in flight
constexpr int kStage = 12;  // loads of the table a thread keeps in flight

struct Args {
  const float2* x;          // the cell (0, 0, 0)
  const float* table;       // (10, F)
  const float* in_domain;   // (F,)
  float* partials;          // one slot per block
  unsigned int* ticket;     // 0 between calls
  float* out;               // one float
  unsigned int n;           // cells, B·F·T
  int F, T;
  int dense;                // the cells fill [x, x + n) in some axis order
  unsigned int bin_stride;  // dense: a cell's bin is (offset / bin_stride) % F
  unsigned int head;        // dense: 1 when x is not 16-byte aligned
  long long sB, sF, sT;     // strided walk: strides in complex elements
};

// w·power of one cell; tab is (10, F) and dom (F,) in shared memory
__device__ __forceinline__ float weighted_power(float2 z, unsigned int f, const float* tab,
                                                const float* dom, int F) {
  // rounded product by product, as the plain version's re*re + im*im
  const float power = __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
  const float spl = 10.0f * log10f(power + 1e-10f);
  float w = 1.0f;
  if (spl >= 0.0f && spl <= 90.0f && dom[f] > 0.5f) {
    const float pos = spl / 10.0f;
    const float i0 = fminf(fmaxf(floorf(pos), 0.0f), 8.0f);
    const float frac = fminf(fmaxf(pos - i0, 0.0f), 1.0f);
    const int i = static_cast<int>(i0);
    w = tab[i * F + f] * (1.0f - frac) + tab[(i + 1) * F + f] * frac;
  }
  return w * power;
}

// the bin of the cell at offset c of a dense walk
__device__ __forceinline__ unsigned int bin_of(unsigned int c, const Args& a) {
  return (a.bin_stride == 1 ? c : c / a.bin_stride) % a.F;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sum in a fixed order: each warp's, then the warps' by warp 0.
// The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < static_cast<int>(blockDim.x) / 32 ? red[lane] : 0.0f);
  return v;
}

// The (10, F) table, then the (F,) mask, into smem[0, 11·F): every load of
// a thread is issued before its first store, so the staging costs about
// one round trip to L2, not one per load.
__device__ __forceinline__ void stage_tables(const Args& a, float* smem) {
  const int n_tab = 10 * a.F, total = 11 * a.F;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStage * blockDim.x) {
    float r[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * static_cast<int>(blockDim.x);
      r[k] = i < n_tab ? __ldg(a.table + i) : i < total ? __ldg(a.in_domain + i - n_tab) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * static_cast<int>(blockDim.x);
      if (i < total) smem[i] = r[k];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) fm_power_sum_kernel(Args a) {
  extern __shared__ float smem[];  // tab (10·F), then dom (F)
  __shared__ float red[kMaxThreads / 32];
  float* tab = smem;
  float* dom = smem + 10 * a.F;
  const unsigned int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned int nthreads = gridDim.x * blockDim.x;

  // dense walk: pairs of cells after the head cell, 16-byte aligned
  const float4* x4 = reinterpret_cast<const float4*>(a.x + a.head);
  const unsigned int pairs = a.dense ? (a.n - a.head) / 2 : 0;
  float4 v[kBatch];
  auto load_batch = [&](unsigned int base) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const unsigned int p = base + k * nthreads;
      v[k] = p < pairs ? __ldg(x4 + p) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  load_batch(gtid);  // in flight while the table is staged

  stage_tables(a, smem);
  __syncthreads();

  float acc = 0.0f;
  if (a.dense) {
    const unsigned int step = kBatch * nthreads;
    for (unsigned int base = gtid; base < pairs; base += step) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const unsigned int p = base + k * nthreads;
        if (p < pairs) {
          const unsigned int c = a.head + 2 * p;  // the pair's first cell
          acc += weighted_power(make_float2(v[k].x, v[k].y), bin_of(c, a), tab, dom, a.F);
          acc += weighted_power(make_float2(v[k].z, v[k].w), bin_of(c + 1, a), tab, dom, a.F);
        }
      }
      if (base + step < pairs) load_batch(base + step);
    }
    if (gtid == 0) {  // the unaligned head cell and an odd last cell
      if (a.head) acc += weighted_power(a.x[0], 0, tab, dom, a.F);
      if ((a.n - a.head) % 2) {
        const unsigned int c = a.n - 1;
        acc += weighted_power(a.x[c], bin_of(c, a), tab, dom, a.F);
      }
    }
  } else {
    for (unsigned int c = gtid; c < a.n; c += nthreads) {
      const unsigned int t = c % a.T;
      const unsigned int f = (c / a.T) % a.F;
      const unsigned int b = c / a.T / a.F;
      acc += weighted_power(__ldg(a.x + b * a.sB + f * a.sF + t * a.sT), f, tab, dom, a.F);
    }
  }

  const float total = block_sum(acc, red);
  if (threadIdx.x >= 32) return;  // warp 0 finishes
  bool last = false;
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = total;
    // release: this partial is visible before the ticket is taken; acquire:
    // the block that takes the last ticket sees every partial
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> ticket(*a.ticket);
    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    if (last) ticket.store(0u, cuda::memory_order_relaxed);  // for the next call
  }
  __syncwarp();
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  float part = 0.0f;
  for (unsigned int i = threadIdx.x; i < gridDim.x; i += 32) part += __ldcg(a.partials + i);
  part = warp_sum(part);
  if (threadIdx.x == 0) a.out[0] = part;
}

// dense: the cells fill one block of n elements in some order of the axes
bool is_dense(const int size[3], const long long stride[3]) {
  int order[3] = {0, 1, 2};  // axes by stride, size-1 axes are free
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  long long expect = 1;
  for (int k = 0; k < 3; ++k) {
    const int d = order[k];
    if (size[d] == 1) continue;
    if (stride[d] != expect) return false;
    expect *= size[d];
  }
  return true;
}

}  // namespace

// x: complex64 (B, F, T) at strides (sB, sF, sT) in complex elements, 8-byte
// aligned; table: (10, F) float32; in_domain: (F,) float32; partials:
// max_blocks float32 slots; ticket: one unsigned int, 0 before the first
// call (each call leaves it at 0); out: one float32. threads: a multiple of
// 32 up to 1024. One kernel launch on `stream`.
extern "C" int paa_fm_power_sum(const void* x, const void* table, const void* in_domain,
                                void* partials, void* ticket, void* out, int B, int F, int T,
                                long long sB, long long sF, long long sT, int max_blocks,
                                int threads, void* stream) {
  const long long n = static_cast<long long>(B) * F * T;
  if (n >= (1LL << 31) || reinterpret_cast<uintptr_t>(x) % 8 != 0 || max_blocks < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || F < 1) {
    return cudaErrorInvalidValue;
  }
  const int size[3] = {B, F, T};
  const long long stride[3] = {sB, sF, sT};
  Args a{static_cast<const float2*>(x), static_cast<const float*>(table),
         static_cast<const float*>(in_domain), static_cast<float*>(partials),
         static_cast<unsigned int*>(ticket), static_cast<float*>(out),
         static_cast<unsigned int>(n), F, T, is_dense(size, stride) ? 1 : 0,
         static_cast<unsigned int>(F > 1 ? sF : 1),
         static_cast<unsigned int>(reinterpret_cast<uintptr_t>(x) % 16 != 0 && n > 0),
         sB, sF, sT};
  const long long work = a.dense ? (n - a.head) / 2 : n;
  const int blocks = static_cast<int>(
      std::max(1LL, std::min<long long>(max_blocks, (work + threads - 1) / threads)));
  const size_t smem = 11 * static_cast<size_t>(F) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fm_power_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fm_power_sum_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

extern "C" const char* paa_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
