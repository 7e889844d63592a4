// K3 — Fletcher-Munson weighted power sum on Hopper.
//
// Replaces paa_tpu/ops/pallas/fm_norm.py:_kernel (launched by
// fm_weighted_power_sum): Σ w·(re² + im²) over the cells of an STFT, with
// SPL = 10·log10(power + 1e-10), w the lerp of the (10, F) ISO-226 table
// along the phon axis at SPL/10, and w = 1 where SPL lies outside [0, 90] or
// the bin outside [20, 20000] Hz. The square root is taken outside.
//
// What bounds it on the H100: one read of 8 bytes per cell and a few dozen
// flops; at the main-path shape (1, 513, 626) that is 2.6 MB, so the launch
// and the fill of the card bound it, not bandwidth. The TPU grid
// (B, ⌈T/128⌉) would give the H100 five blocks.
//
// Design: two passes, deterministic, no float atomics.
//   1. grid (⌈T/128⌉, B·⌈F/16⌉): a block of 128 threads owns 16 bins × 128
//      frames, loads its 16 columns of the table and of the in-domain mask
//      into shared memory, reads the complex64 input as interleaved
//      (re, im) float pairs (torch.view_as_real, no copies), one frame per
//      thread so that a warp reads 256 contiguous bytes per bin, and writes
//      its partial sum to its own slot.
//   2. one block of 256 threads sums the partials in a fixed order.
// The lerp is written as the gather the plain version uses; with the phon
// grid at 0, 10, ..., 90 it equals the TPU kernel's sum of hat functions.
#include <cuda_runtime.h>

namespace {

constexpr int kFT = 16;        // bins per block
constexpr int kTT = 128;       // frames per block, one per thread
constexpr int kSumThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) total += red[w];
  }
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(kTT)
fm_partial_kernel(const float2* __restrict__ x, const float* __restrict__ table,
                  const float* __restrict__ in_domain, float* __restrict__ partials, int F,
                  int T_len, int n_ftiles) {
  __shared__ float tab[10][kFT];
  __shared__ float dom[kFT];
  __shared__ float red[kTT / 32];
  const int b = blockIdx.y / n_ftiles;
  const int f0 = (blockIdx.y % n_ftiles) * kFT;
  for (int i = threadIdx.x; i < 10 * kFT; i += blockDim.x) {
    const int p = i / kFT;
    const int j = i % kFT;
    tab[p][j] = (f0 + j < F) ? table[p * F + f0 + j] : 0.0f;
  }
  for (int j = threadIdx.x; j < kFT; j += blockDim.x) dom[j] = (f0 + j < F) ? in_domain[f0 + j] : 0.0f;
  __syncthreads();

  const int t = blockIdx.x * kTT + threadIdx.x;
  float acc = 0.0f;
  if (t < T_len) {
    for (int j = 0; j < kFT && f0 + j < F; ++j) {
      const float2 z = x[(static_cast<long>(b) * F + f0 + j) * T_len + t];
      // rounded product by product, as the plain version's re*re + im*im
      const float power = __fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y));
      const float spl = 10.0f * log10f(power + 1e-10f);
      float w = 1.0f;
      if (spl >= 0.0f && spl <= 90.0f && dom[j] > 0.5f) {
        const float pos = spl / 10.0f;
        const float i0 = fminf(fmaxf(floorf(pos), 0.0f), 8.0f);
        const float frac = fminf(fmaxf(pos - i0, 0.0f), 1.0f);
        const int i = static_cast<int>(i0);
        w = tab[i][j] * (1.0f - frac) + tab[i + 1][j] * frac;
      }
      acc += w * power;
    }
  }
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kSumThreads)
fm_sum_kernel(const float* __restrict__ partials, int n, float* __restrict__ out) {
  __shared__ float red[kSumThreads / 32];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float total = block_sum(acc, red);
  if (threadIdx.x == 0) out[0] = total;
}

void grid_of(int B, int F, int T_len, int* n_ftiles, dim3* grid) {
  *n_ftiles = (F + kFT - 1) / kFT;
  *grid = dim3((T_len + kTT - 1) / kTT, B * *n_ftiles);
}

}  // namespace

// Slots the first pass writes: the size of the `partials` scratch buffer.
extern "C" int paa_fm_num_partials(int B, int F, int T_len) {
  int n_ftiles;
  dim3 grid;
  grid_of(B, F, T_len, &n_ftiles, &grid);
  return static_cast<int>(grid.x * grid.y);
}

// x: (B, F, T, 2) float32 contiguous (a complex64 STFT as real pairs);
// table: (10, F) float32; in_domain: (F,) float32; partials: float32
// scratch of paa_fm_num_partials(B, F, T) slots; out: one float32.
extern "C" int paa_fm_power_sum(const void* x, const void* table, const void* in_domain,
                                void* partials, void* out, int B, int F, int T_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int n_ftiles;
  dim3 grid;
  grid_of(B, F, T_len, &n_ftiles, &grid);
  fm_partial_kernel<<<grid, kTT, 0, s>>>(static_cast<const float2*>(x),
                                         static_cast<const float*>(table),
                                         static_cast<const float*>(in_domain),
                                         static_cast<float*>(partials), F, T_len, n_ftiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fm_sum_kernel<<<1, kSumThreads, 0, s>>>(static_cast<const float*>(partials),
                                          static_cast<int>(grid.x * grid.y),
                                          static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" const char* paa_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
