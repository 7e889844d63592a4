// K7 — the encoder's LayerNorm on Hopper: the LayerNorm over the last axis
// of every encoder layer (lv60 pre-LN, base post-LN, the LayerNorm before or
// after the stack), of every conformer block and its conv module, and of the
// feature projection, in one pass forward and one backward over rows of C
// contiguous values; bf16 or float32.
//
// What it replaces. No TPU kernel: the JAX package's _layernorm custom VJP
// (paa_tpu/models/wav2vec2.py:803-852, _layernorm_fwd and _layernorm_bwd)
// is plain jnp, which XLA fuses on the TPU. On the H100 the port's eager
// _LayerNormFn ran eight passes forward (a float32 mean, a float32 copy of
// x, an in-place square, a second mean, sub, mul_, addcmul, a cast of x̂)
// and, backward, float32 casts of g and x̂, aten's LayerNorm backward in
// float32 and a scaled write: 1.28 ms a call pair at (32, 999, 1024) bf16.
//
// What it computes, for each row of C values, in float32, as the reference:
//   forward:  s = Σ x, q = Σ x² (one pass); mean = s/C;
//             var = max(q/C − mean², 0) (the fast variance, not Welford's
//             or a two-pass one); rstd = 1/sqrt(var + eps);
//             x̂ = (x − mean)·rstd; out = β + x̂·γ, rounded once to the
//             input's type; with grad on, x̂ stored in the input's type and
//             rstd as float32, one a row;
//   backward: dx̂ = g·γ; dx = rstd·(dx̂ − mean(dx̂) − x̂·mean(dx̂·x̂)),
//             rounded once; with weight gradients, Σ g·x̂ (γ) and Σ g (β)
//             over the rows, one float32 row of 2·C a block of a grid the
//             caller sizes (twice the SMs), which the wrapper sums.
//
// What bounds it on the H100: bytes. The forward reads x and writes out and
// x̂, 6 B a value in bf16 (4 B with grad off, when x̂ is not stored); the
// backward reads g and x̂ and writes dx, 6 B a value. rstd and the
// parameters are C times smaller. At lv60's microbatch, (32, 999, 1024)
// bf16: 196 MB each way, 0.0586 ms at 3.35 TB/s.
//
// Design. A warp owns a row: lane l holds the 8-value chunks l, l + 32, …
// (one 16-byte load each in bf16, two in float32), N of them where
// N = ⌈C/256⌉ is a template parameter (2, 3 and 4 at C = 512, 768 and 1024,
// every lane busy), so the row stays in registers between its sums and its
// writes and each value is read from device memory once. The two sums of a
// row are warp shuffles (the loads, stores and sums are row_io.cuh's, which
// K6's row kernels share); 8 warps a block, one row each, so a microbatch of
// 31 968 rows is 3 996 blocks, several waves over the 132 SMs. Forward and
// backward are each one launch.
//   - With weight gradients the grid is the caller's: each warp walks rows
//     and keeps its lanes' channels' Σ g·x̂ and Σ g in registers; the
//     block's warps add theirs in shared memory in a fixed order, so a
//     repeat gives the same bits, and the block writes one row.
//
// Any C that is a multiple of 8 up to 1024 is taken (rows start at 16-byte
// boundaries). The host entry points return cudaGetLastError() after the
// launch, and the wrapper raises on anything but 0, as for the other
// kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_io.cuh"

namespace paa {
namespace layernorm {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // rows a block, one a warp
constexpr int kMaxC = 1024;
constexpr int kMaxChunks = kMaxC / 8 / 32;  // 8-value chunks a lane holds at most

// One row a warp; kSave writes x̂ and rstd for the backward.
template <class E, int N, bool kSave>
__global__ void __launch_bounds__(kWarps * 32) layer_norm_fwd_kernel(
    const E* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    E* __restrict__ out, E* __restrict__ xhat, float* __restrict__ rstd_out, int rows, int C,
    float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = C / 8;
  const size_t base = size_t(row) * C;

  float v[N][8];
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = lane + 32 * k;
    if (j < chunks) {
      load8(x + base + 8 * j, v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[k][e];
        q = fmaf(v[k][e], v[k][e], q);
      }
    }
  }
  const float mean = warp_sum(s) / C;
  const float msq = warp_sum(q) / C;
  const float rstd = rsqrtf(fmaxf(msq - mean * mean, 0.f) + eps);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = lane + 32 * k;
    if (j < chunks) {
      float ga[8], be[8], o[8];
      load8(gamma + 8 * j, ga);
      load8(beta + 8 * j, be);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[k][e] = (v[k][e] - mean) * rstd;
        o[e] = fmaf(v[k][e], ga[e], be[e]);
      }
      store8(out + base + 8 * j, o);
      if (kSave) store8(xhat + base + 8 * j, v[k]);
    }
  }
  if (kSave && lane == 0) rstd_out[row] = rstd;
}

// Each warp walks rows first, first + 8·gridDim.x, …: one row without
// kWgrad (the grid covers the rows); with it the grid is the caller's, and
// the block writes its row of Σ g·x̂ and Σ g to partial at the end.
template <class E, int N, bool kWgrad>
__global__ void __launch_bounds__(kWarps * 32) layer_norm_bwd_kernel(
    const E* __restrict__ g, const E* __restrict__ xhat, const float* __restrict__ rstd_in,
    const float* __restrict__ gamma, E* __restrict__ dx, float* __restrict__ partial, int rows,
    int C) {
  constexpr int kAcc = kWgrad ? N : 1;
  __shared__ float wsum[kWgrad ? 2 * kMaxC : 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = C / 8;
  float dg[kAcc][8], db[kAcc][8];
  if constexpr (kWgrad) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
#pragma unroll
      for (int e = 0; e < 8; ++e) dg[k][e] = db[k][e] = 0.f;
    }
  }

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const size_t base = size_t(row) * C;
    const float r = rstd_in[row];
    float d[N][8], xh[N][8];  // d: g, then dx̂
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = lane + 32 * k;
      if (j < chunks) {
        float ga[8];
        load8(g + base + 8 * j, d[k]);
        load8(xhat + base + 8 * j, xh[k]);
        load8(gamma + 8 * j, ga);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if constexpr (kWgrad) {
            dg[k][e] = fmaf(d[k][e], xh[k][e], dg[k][e]);
            db[k][e] += d[k][e];
          }
          d[k][e] *= ga[e];
          s1 += d[k][e];
          s2 = fmaf(d[k][e], xh[k][e], s2);
        }
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = lane + 32 * k;
      if (j < chunks) {
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = r * (d[k][e] - m1 - xh[k][e] * m2);
        store8(dx + base + 8 * j, o);
      }
    }
  }
  if constexpr (kWgrad) {
    // the warps add their sums in turn, warp 0 first: a fixed order
    for (int w = 0; w < kWarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int k = 0; k < kAcc; ++k) {
          const int j = lane + 32 * k;
          if (j < chunks) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int c = 8 * j + e;
              wsum[c] = w == 0 ? dg[k][e] : wsum[c] + dg[k][e];
              wsum[kMaxC + c] = w == 0 ? db[k][e] : wsum[kMaxC + c] + db[k][e];
            }
          }
        }
      }
      __syncthreads();
    }
    float* row = partial + size_t(blockIdx.x) * 2 * C;
    for (int c = threadIdx.x; c < C; c += kWarps * 32) {
      row[c] = wsum[c];
      row[C + c] = wsum[kMaxC + c];
    }
  }
}

// ---------------------------------------------------------------------------
// host side

bool shape_ok(int rows, int C) { return rows >= 1 && C >= 8 && C <= kMaxC && C % 8 == 0; }

struct FwdArgs {
  const void *x, *gamma, *beta;
  void *out, *xhat, *rstd;
  int rows, C;
  float eps;
  cudaStream_t stream;
};

struct BwdArgs {
  const void *g, *xhat, *rstd, *gamma;
  void *dx, *partial;
  int grid, rows, C;  // grid: the blocks that write weight-gradient rows
  cudaStream_t stream;
};

template <class E, int N>
int launch_fwd(const FwdArgs& a) {
  const int grid = (a.rows + kWarps - 1) / kWarps;
  const auto* x = static_cast<const E*>(a.x);
  const auto* gamma = static_cast<const float*>(a.gamma);
  const auto* beta = static_cast<const float*>(a.beta);
  auto* out = static_cast<E*>(a.out);
  auto* xhat = static_cast<E*>(a.xhat);
  auto* rstd = static_cast<float*>(a.rstd);
  if (a.xhat)
    layer_norm_fwd_kernel<E, N, true><<<grid, kWarps * 32, 0, a.stream>>>(
        x, gamma, beta, out, xhat, rstd, a.rows, a.C, a.eps);
  else
    layer_norm_fwd_kernel<E, N, false><<<grid, kWarps * 32, 0, a.stream>>>(
        x, gamma, beta, out, xhat, rstd, a.rows, a.C, a.eps);
  return cudaGetLastError();
}

template <class E, int N>
int launch_bwd(const BwdArgs& a) {
  const auto* g = static_cast<const E*>(a.g);
  const auto* xhat = static_cast<const E*>(a.xhat);
  const auto* rstd = static_cast<const float*>(a.rstd);
  const auto* gamma = static_cast<const float*>(a.gamma);
  auto* dx = static_cast<E*>(a.dx);
  auto* partial = static_cast<float*>(a.partial);
  if (a.partial)
    layer_norm_bwd_kernel<E, N, true><<<a.grid, kWarps * 32, 0, a.stream>>>(
        g, xhat, rstd, gamma, dx, partial, a.rows, a.C);
  else
    layer_norm_bwd_kernel<E, N, false><<<(a.rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                                         a.stream>>>(g, xhat, rstd, gamma, dx, partial, a.rows,
                                                     a.C);
  return cudaGetLastError();
}

// the chunks a lane holds, ⌈C / 256⌉: 1 to kMaxChunks
static_assert(kMaxChunks == 4, "one case per chunk count");

template <class E>
int fwd_typed(const FwdArgs& a) {
  switch ((a.C + 255) / 256) {
    case 1: return launch_fwd<E, 1>(a);
    case 2: return launch_fwd<E, 2>(a);
    case 3: return launch_fwd<E, 3>(a);
    default: return launch_fwd<E, 4>(a);
  }
}

template <class E>
int bwd_typed(const BwdArgs& a) {
  switch ((a.C + 255) / 256) {
    case 1: return launch_bwd<E, 1>(a);
    case 2: return launch_bwd<E, 2>(a);
    case 3: return launch_bwd<E, 3>(a);
    default: return launch_bwd<E, 4>(a);
  }
}

}  // namespace
}  // namespace layernorm
}  // namespace paa

// x, out, xhat: contiguous rows × C, bfloat16 (is_bf16) or float32, 16-byte
// aligned; gamma, beta: (C,) float32; xhat and rstd (rows,) float32 are
// written when both are given (grad on), else both null.
extern "C" int paa_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* out,
                                  void* xhat, void* rstd, int rows, int C, float eps, int is_bf16,
                                  void* stream) {
  using namespace paa::layernorm;
  if (!shape_ok(rows, C) || (xhat == nullptr) != (rstd == nullptr)) return cudaErrorInvalidValue;
  const FwdArgs a{x, gamma, beta, out, xhat, rstd, rows, C, eps,
                  static_cast<cudaStream_t>(stream)};
  return is_bf16 ? fwd_typed<bf16>(a) : fwd_typed<float>(a);
}

// g, xhat, dx: as x of the forward; rstd: the forward's (rows,) float32;
// gamma: (C,) float32; partial: null, or (grid, 2, C) float32 for the
// weight gradients' rows (Σ g·x̂, Σ g a block), grid ≥ 1.
extern "C" int paa_layer_norm_bwd(const void* g, const void* xhat, const void* rstd,
                                  const void* gamma, void* dx, void* partial, int grid, int rows,
                                  int C, int is_bf16, void* stream) {
  using namespace paa::layernorm;
  if (!shape_ok(rows, C) || (partial != nullptr && grid < 1)) return cudaErrorInvalidValue;
  const BwdArgs a{g, xhat, rstd, gamma, dx, partial, grid, rows, C,
                  static_cast<cudaStream_t>(stream)};
  return is_bf16 ? bwd_typed<bf16>(a) : bwd_typed<float>(a);
}
