// K6 — the feature extractor's norm on Hopper: conv bias + LayerNorm over
// channels + GELU of every layer of lv60's feature extractor (the conformer
// shares it), in one fused pass forward and one backward, on the conv's
// output in either layout the port runs: cuDNN's (B, C, T) and the (B, T, C)
// of the conv lowerings; bf16 or float32.
//
// What it replaces. No TPU kernel: the JAX package runs this chain (the conv
// bias add, _FeNorm over axis −1, nn.gelu) as plain jnp operations
// (paa_tpu/models/wav2vec2.py:445-456 and _FeNorm :475), which XLA fuses on
// the TPU. On the H100 the eager chain was a bias pass in bf16; _FeNorm's
// float32 copy, var_mean, four in-place float32 passes and a cast; and a GELU
// pass. Its backward rebuilt x̂ in float32 and ran about ten more float32
// passes: about 56 bytes a value forward and 100 backward, where the per-frame
// broadcasts of the mean and 1/std along C ran ATen's unvectorised
// elementwise kernels.
//
// What it computes, for each frame (b, t), over the C channels, in float32:
//   forward:  x = y + bias; mu = mean(x) and var = mean((x − mu)²), two
//             passes as var_mean takes them (not E[x²] − E[x]²);
//             rstd = 1/sqrt(var + eps); z = (x − mu)·rstd·γ + β;
//             out = gelu(z), rounded once to the input's type; mu and rstd
//             written as float32 (B, T) when the backward will need them;
//   backward: x̂ rebuilt from y, bias, mu and rstd; dz = g·gelu'(z);
//             dx̂ = dz·γ; dx = rstd·(dx̂ − mean_C(dx̂) − x̂·mean_C(dx̂·x̂)),
//             rounded once; with weight gradients, Σ dz·x̂ (γ), Σ dz (β) and
//             Σ dx (the conv bias) over the frames, one float32 row of 3·C a
//             block of a grid the caller sizes (twice the SMs), which the
//             wrapper sums.
// The GELU is tanh's form, written as z·σ(2u) with u = √(2/π)(z + 0.044715 z³)
// since 0.5(1 + tanh u) = σ(2u) (one ex2 and one reciprocal), or the exact
// erf form. Nothing the size of the layer is written in float32 but a float32
// layer's own output.
//
// What bounds it on the H100: bytes. The forward reads y and writes out, 4 B
// a value in bf16; the backward reads y and g and writes dx, 6 B a value (mu,
// rstd and the parameters are C times smaller). lv60's layer 0 for a
// microbatch of 32 clips of 20 s, (32, 512, 63 999): 4.19 GB forward,
// 1.25 ms at 3.35 TB/s; 6.29 GB backward, 1.88 ms.
//
// Design, (B, C, T) (the tile kernels). The sums run over C, at stride T,
// and the contiguous axis is T, which is odd at every lv60 layer (63 999 …
// 999): a channel row starts at any 2-byte boundary, so neither TMA (16-byte
// strides) nor vector loads apply.
//   - A block owns 32 consecutive frames of one clip across all C channels,
//     512 threads. Lane l holds frame t0 + l; warp w holds channels w,
//     w + 16, …. Each warp load reads 32 frames of one channel row, 64
//     contiguous bytes in bf16, and a warp keeps 16 rows' loads in flight
//     before it uses the first.
//   - The tile is staged in shared memory as it is read, and its per-frame
//     sums are taken on the way. The 16 warps' sums meet in shared memory in
//     a fixed order, so a repeat gives the same bits. Every later pass reads
//     the tile from shared memory, never device memory again.
//   - Forward: pass 1 reads y, stages it and sums it (Σ bias is added once);
//     pass 2 sums (x − mu)² from the tile; pass 3 normalises, applies γ, β
//     and the GELU and writes out. Shared memory (16 + 32·size(y))·C bytes:
//     40 KB at C = 512 in bf16, two blocks an SM (registers).
//   - Backward: pass 1 reads y and g, stages y, keeps dz in shared memory as
//     float32 and sums dx̂ and dx̂·x̂; pass 2 rebuilds x̂ from the staged y and
//     writes dx. Keeping dz spares pass 2 the GELU's derivative. Shared
//     memory 208·C bytes in bf16: 104 KB at C = 512, two blocks an SM. A
//     float32 y is not staged (it would not fit at C = 1024): pass 2 reads
//     it again, from L2, 144·C bytes.
//   - With weight gradients the grid is the caller's (twice the SMs), each
//     block walks its tiles in turn, and its warps keep each channel's three
//     sums in registers (a channel's sum over the tile's frames is a warp
//     sum), written as the block's one row at the end.
//   - The ragged last tile is masked: its dead lanes read zeros and write
//     nothing.
// What holds it above the byte bound: at odd T a warp's 64-byte store starts
// inside a 32-byte sector and ends inside another, and such partial-sector
// stores alone run at 0.8 TB/s on the H100 (whole sectors 3.0 TB/s; loads of
// this pattern 2.5 TB/s). Designs that write whole sectors measured slower at
// layer 0, forward / backward, against 2.72 / 4.49 ms: a block that also
// computes the 16 frames past its own, 3.57 / 6.25 ms (the extra loads and
// sums); clusters of 8 blocks that stage their outputs and write whole
// sectors with the next block's first frames, 5.39 / 6.68 ms (the staging
// and the cluster barriers). Prefetching the partial sectors into L2, or
// streaming stores, did not help either.
//
// Design, (B, T, C) (the row kernels). The C channels of a frame are one
// contiguous row, 16-byte aligned since C is a multiple of 8: a warp owns a
// row, each lane up to four chunks of 8 channels (one 16-byte load in bf16),
// held in registers through both sums and the write; 8 warps a block. With
// weight gradients each warp adds its rows' three sums a channel into its
// own slice of shared memory (8·3·C floats), summed over the warps in a
// fixed order at the end.
//
// Any C that is a multiple of 8 up to 1024 is taken. The host entry points
// return cudaGetLastError() after the launch, and the wrapper raises on
// anything but 0, as for the other kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "row_io.cuh"

namespace paa {
namespace fenorm {
namespace {

using bf16 = __nv_bfloat16;
using u16 = unsigned short;

constexpr int kFrames = 32;  // tile kernels: frames a block, one a lane
constexpr int kWarps = 16;   // warp w takes channels w, w + 16, …
constexpr int kBatch = 16;   // channel rows a warp loads before it uses one
constexpr int kMaxC = 1024;
constexpr int kSlots = kMaxC / kWarps / 32;  // channels a lane sums weight gradients of
constexpr int kRowWarps = 8;                 // row kernels: frames a block, one a warp
constexpr int kChunks = kMaxC / 8 / 32;      // 8-channel chunks a lane holds

// The element types: y, g, out and dx are bf16 (read as their bits) or
// float32; everything computed is float32.
template <class E>
struct Elem;
template <>
struct Elem<bf16> {
  using Raw = u16;
  __device__ static __forceinline__ float f(u16 v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  __device__ static __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
};
template <>
struct Elem<float> {
  using Raw = float;
  __device__ static __forceinline__ float f(float v) { return v; }
  __device__ static __forceinline__ void store(float* p, float v) { *p = v; }
};

// dynamic shared memory of the tile kernels: the parameters (bias, γ, β as
// one float4 a channel), the staged y and, in the backward, dz (float32);
// a float32 y is not staged in the backward
template <class E>
__host__ __device__ constexpr bool stage_y_bwd() { return sizeof(E) == 2; }
template <class E>
constexpr int fwd_smem(int C) { return C * (16 + kFrames * int(sizeof(E))); }
template <class E>
constexpr int bwd_smem(int C) {
  return C * (16 + kFrames * 4 + (stage_y_bwd<E>() ? kFrames * int(sizeof(E)) : 0));
}
// the row kernels' weight-gradient sums, a slice a warp
constexpr int rows_wgrad_smem(int C) { return kRowWarps * 3 * C * 4; }

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kK0 = 0.7978845608028654f;  // √(2/π)
constexpr float kK1 = 0.044715f;
// exp(−2u) = 2^(z·(kA + kB·z²))
constexpr float kA = -2.f * kLog2e * kK0;
constexpr float kB = kA * kK1;
constexpr float kSqrtHalf = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct TanhGelu {
  // e = exp(−2u), its exponent held at 80 or below: σ = 1/(1 + e) then stays
  // a normal float and e·σ finite
  __device__ static __forceinline__ float exp_m2u(float z) {
    return ex2(fminf(z * fmaf(kB, z * z, kA), 80.f));
  }
  __device__ static __forceinline__ float fwd(float z) { return z * rcp(1.f + exp_m2u(z)); }
  // d/dz z·σ(2u) = σ + z·2σ(1 − σ)·u′ = σ·(1 + z·e·σ·(2k0 + 6k0k1·z²)),
  // since 1 − σ = e·σ
  __device__ static __forceinline__ float grad(float z) {
    const float e = exp_m2u(z);
    const float s = rcp(1.f + e);
    return s * fmaf(z * e * s, fmaf(6.f * kK0 * kK1, z * z, 2.f * kK0), 1.f);
  }
};

struct ErfGelu {
  __device__ static __forceinline__ float fwd(float z) {
    return 0.5f * z * (1.f + erff(z * kSqrtHalf));
  }
  __device__ static __forceinline__ float grad(float z) {
    return 0.5f * (1.f + erff(z * kSqrtHalf)) + z * kInvSqrt2Pi * expf(-0.5f * z * z);
  }
};

// Each lane's N values summed over the block's warps, in a fixed order:
// every thread gets the sums of its frame. The barrier after the reads
// frees the slots for the next call.
template <int N>
__device__ __forceinline__ void frame_sums(float (&v)[N], float (&slots)[N][kWarps][kFrames]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) slots[i][warp][lane] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += slots[i][w][lane];
    v[i] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (B, C, T): the tile kernels

template <class Gelu, class E, bool kStats>
__global__ void __launch_bounds__(kWarps * 32, 2) fe_norm_fwd_kernel(
    const typename Elem<E>::Raw* __restrict__ y, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta, E* __restrict__ out,
    float* __restrict__ mean, float* __restrict__ rstd_out, int C, int T, float eps) {
  using Raw = typename Elem<E>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* prm = reinterpret_cast<float4*>(smem);
  Raw* tile = reinterpret_cast<Raw*>(prm + C);
  __shared__ float slots[1][kWarps][kFrames];
  __shared__ float bias_part[kWarps];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kFrames + lane;
  const bool live = t < T;
  const size_t frame = size_t(blockIdx.y) * C * T + t;  // (b, 0, t)

  float bsum = 0.f;
  for (int c = threadIdx.x; c < C; c += kWarps * 32) {
    const float b = bias[c];
    prm[c] = make_float4(b, gamma[c], beta[c], 0.f);
    bsum += b;
  }
  bsum = warp_sum(bsum);
  if (lane == 0) bias_part[warp] = bsum;

  // pass 1: stage y and sum it over the channels, kBatch rows in flight
  float v[1] = {0.f};
  for (int c0 = warp; c0 < C; c0 += kWarps * kBatch) {
    Raw q[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i * kWarps;
      q[i] = live && c < C ? __ldg(y + frame + size_t(c) * T) : Raw(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i * kWarps;
      if (c < C) {
        tile[c * kFrames + lane] = q[i];
        v[0] += Elem<E>::f(q[i]);
      }
    }
  }
  frame_sums(v, slots);  // its barrier also publishes prm and bias_part
  float btot = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) btot += bias_part[w];
  const float mu = (v[0] + btot) / C;

  // pass 2: Σ (x − mu)² from the tile
  v[0] = 0.f;
#pragma unroll 8
  for (int c = warp; c < C; c += kWarps) {
    const float d = Elem<E>::f(tile[c * kFrames + lane]) + prm[c].x - mu;
    v[0] = fmaf(d, d, v[0]);
  }
  frame_sums(v, slots);
  const float rstd = rsqrtf(v[0] / C + eps);

  // pass 3: normalise, scale and shift, GELU, one write
  E* dst = out + frame;
#pragma unroll 8
  for (int c = warp; c < C; c += kWarps) {
    const float4 p = prm[c];
    const float xh = (Elem<E>::f(tile[c * kFrames + lane]) + p.x - mu) * rstd;
    if (live) Elem<E>::store(dst + size_t(c) * T, Gelu::fwd(fmaf(xh, p.y, p.z)));
  }
  if (kStats && warp == 0 && live) {
    const size_t ft = size_t(blockIdx.y) * T + t;
    mean[ft] = mu;
    rstd_out[ft] = rstd;
  }
}

// One tile of the backward: frames 32·tile … of clip b. With kWgrad, each
// channel's Σ dz·x̂, Σ dz and Σ dx over the tile's frames is added to acc:
// channel warp + 16·i is held by lane i mod 32, in slot i / 32.
template <class Gelu, class E, bool kWgrad>
__device__ __forceinline__ void bwd_tile(
    const typename Elem<E>::Raw* __restrict__ g, const typename Elem<E>::Raw* __restrict__ y,
    const float4* prm, float* dz_tile, typename Elem<E>::Raw* y_tile,
    float (&slots)[2][kWarps][kFrames], const float* __restrict__ mean,
    const float* __restrict__ rstd_in, E* __restrict__ dx, int b, int tile, int C, int T,
    float (&acc)[3][kSlots]) {
  using Raw = typename Elem<E>::Raw;
  constexpr bool kStageY = stage_y_bwd<E>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = tile * kFrames + lane;
  const bool live = t < T;
  const size_t frame = size_t(b) * C * T + t;  // (b, 0, t)
  const size_t ft = size_t(b) * T + t;
  // a dead lane's rstd of 0 makes its x̂ and dx 0, and its g reads as 0
  const float mu = live ? mean[ft] : 0.f;
  const float r = live ? rstd_in[ft] : 0.f;

  // pass 1: stage y, keep dz, sum dx̂ and dx̂·x̂ over the channels, kBatch
  // rows of y and of g in flight
  float v[2] = {0.f, 0.f};
  for (int c0 = warp; c0 < C; c0 += kWarps * kBatch) {
    Raw qy[kBatch], qg[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i * kWarps;
      const bool in = live && c < C;
      qy[i] = in ? __ldg(y + frame + size_t(c) * T) : Raw(0);
      qg[i] = in ? __ldg(g + frame + size_t(c) * T) : Raw(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = c0 + i * kWarps;
      if (c < C) {
        const float4 p = prm[c];
        const float xh = (Elem<E>::f(qy[i]) + p.x - mu) * r;
        const float dz = Elem<E>::f(qg[i]) * Gelu::grad(fmaf(xh, p.y, p.z));
        if (kStageY) y_tile[c * kFrames + lane] = qy[i];
        dz_tile[c * kFrames + lane] = dz;
        const float dxh = dz * p.y;
        v[0] += dxh;
        v[1] = fmaf(dxh, xh, v[1]);
      }
    }
  }
  frame_sums(v, slots);
  const float m1 = v[0] / C, m2 = v[1] / C;

  // pass 2: dx from the staged y (a float32 y read again) and dz, one write
  E* dst = dx + frame;
  int i = 0;
#pragma unroll 8
  for (int c = warp; c < C; c += kWarps, ++i) {
    const float4 p = prm[c];
    const Raw yc = kStageY ? y_tile[c * kFrames + lane]
                           : (live ? __ldg(y + frame + size_t(c) * T) : Raw(0));
    const float xh = (Elem<E>::f(yc) + p.x - mu) * r;
    const float dz = dz_tile[c * kFrames + lane];
    const float d = r * (dz * p.y - m1 - xh * m2);
    if (live) Elem<E>::store(dst + size_t(c) * T, d);
    if (kWgrad) {
      const float sg = warp_sum(dz * xh), sb = warp_sum(dz), sx = warp_sum(d);
      if (lane == (i & 31)) {
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s == i >> 5) {
            acc[0][s] += sg;
            acc[1][s] += sb;
            acc[2][s] += sx;
          }
        }
      }
    }
  }
}

template <class Gelu, class E, bool kWgrad>
__global__ void __launch_bounds__(kWarps * 32, 2) fe_norm_bwd_kernel(
    const typename Elem<E>::Raw* __restrict__ g, const typename Elem<E>::Raw* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ rstd_in, E* __restrict__ dx, float* __restrict__ partial, int B,
    int C, int T) {
  using Raw = typename Elem<E>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* prm = reinterpret_cast<float4*>(smem);
  float* dz_tile = reinterpret_cast<float*>(prm + C);
  Raw* y_tile = reinterpret_cast<Raw*>(dz_tile + C * kFrames);
  __shared__ float slots[2][kWarps][kFrames];

  for (int c = threadIdx.x; c < C; c += kWarps * 32)
    prm[c] = make_float4(bias[c], gamma[c], beta[c], 0.f);
  __syncthreads();

  float acc[3][kSlots] = {};
  if (!kWgrad) {  // grid (⌈T/32⌉, B): one tile a block
    bwd_tile<Gelu, E, false>(g, y, prm, dz_tile, y_tile, slots, mean, rstd_in, dx, blockIdx.y,
                             blockIdx.x, C, T, acc);
    return;
  }
  // the caller's grid: each block walks its tiles, then writes its row
  const int tiles = (T + kFrames - 1) / kFrames;
  for (int u = blockIdx.x; u < B * tiles; u += gridDim.x) {
    bwd_tile<Gelu, E, true>(g, y, prm, dz_tile, y_tile, slots, mean, rstd_in, dx, u / tiles,
                            u % tiles, C, T, acc);
    __syncthreads();  // the next tile overwrites the staged y and dz
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* row = partial + size_t(blockIdx.x) * 3 * C;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = warp + kWarps * (lane + 32 * s);
    if (c < C) {
      row[c] = acc[0][s];
      row[C + c] = acc[1][s];
      row[2 * C + c] = acc[2][s];
    }
  }
}

// ---------------------------------------------------------------------------
// (B, T, C): the row kernels (their loads, stores and warp sums in
// row_io.cuh, shared with layer_norm.cu)

template <class Gelu, class E, bool kStats>
__global__ void __launch_bounds__(kRowWarps * 32) fe_norm_rows_fwd_kernel(
    const E* __restrict__ y, const float* __restrict__ bias, const float* __restrict__ gamma,
    const float* __restrict__ beta, E* __restrict__ out, float* __restrict__ mean,
    float* __restrict__ rstd_out, int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int chunks = C / 8;
  const size_t base = size_t(row) * C;

  float x[kChunks][8];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = lane + 32 * k;
    if (j < chunks) {
      float b[8];
      load8(y + base + 8 * j, x[k]);
      load8(bias + 8 * j, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[k][e] += b[e];
        s += x[k][e];
      }
    }
  }
  const float mu = warp_sum(s) / C;
  s = 0.f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (lane + 32 * k < chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = x[k][e] - mu;
        s = fmaf(d, d, s);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(s) / C + eps);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int j = lane + 32 * k;
    if (j < chunks) {
      float ga[8], be[8], o[8];
      load8(gamma + 8 * j, ga);
      load8(beta + 8 * j, be);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = Gelu::fwd(fmaf((x[k][e] - mu) * rstd, ga[e], be[e]));
      store8(out + base + 8 * j, o);
    }
  }
  if (kStats && lane == 0) {
    mean[row] = mu;
    rstd_out[row] = rstd;
  }
}

// Without kWgrad the grid covers the rows, one a warp; with it the grid is
// the caller's and each warp walks its rows, adding their weight-gradient
// sums into its slice of shared memory.
template <class Gelu, class E, bool kWgrad>
__global__ void __launch_bounds__(kRowWarps * 32) fe_norm_rows_bwd_kernel(
    const E* __restrict__ g, const E* __restrict__ y, const float* __restrict__ bias,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ rstd_in, E* __restrict__ dx,
    float* __restrict__ partial, int rows, int C) {
  extern __shared__ __align__(16) float wsum[];  // kWgrad: [kRowWarps][3][C]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = C / 8;
  float* mine = wsum + warp * 3 * C;
  if (kWgrad) {
    for (int i = threadIdx.x; i < kRowWarps * 3 * C; i += blockDim.x) wsum[i] = 0.f;
    __syncthreads();
  }

  for (int row = blockIdx.x * kRowWarps + warp; row < rows; row += gridDim.x * kRowWarps) {
    const size_t base = size_t(row) * C;
    const float mu = mean[row], r = rstd_in[row];
    float xh[kChunks][8], dz[kChunks][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = lane + 32 * k;
      if (j < chunks) {
        float gv[8], b[8], ga[8], be[8];
        load8(y + base + 8 * j, xh[k]);
        load8(g + base + 8 * j, gv);
        load8(bias + 8 * j, b);
        load8(gamma + 8 * j, ga);
        load8(beta + 8 * j, be);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xh[k][e] = (xh[k][e] + b[e] - mu) * r;
          dz[k][e] = gv[e] * Gelu::grad(fmaf(xh[k][e], ga[e], be[e]));
          const float dxh = dz[k][e] * ga[e];
          s1 += dxh;
          s2 = fmaf(dxh, xh[k][e], s2);
        }
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int j = lane + 32 * k;
      if (j < chunks) {
        float ga[8], d[8];
        load8(gamma + 8 * j, ga);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = r * (dz[k][e] * ga[e] - m1 - xh[k][e] * m2);
        store8(dx + base + 8 * j, d);
        if (kWgrad) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = 8 * j + e;
            mine[c] = fmaf(dz[k][e], xh[k][e], mine[c]);
            mine[C + c] += dz[k][e];
            mine[2 * C + c] += d[e];
          }
        }
      }
    }
  }
  if (kWgrad) {
    __syncthreads();
    float* out = partial + size_t(blockIdx.x) * 3 * C;
    for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) s += wsum[w * 3 * C + i];
      out[i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// host side

bool shape_ok(int B, int C, int T) {
  return B >= 1 && B <= 65535 && T >= 1 && C >= 8 && C <= kMaxC && C % 8 == 0 &&
         static_cast<long long>(B) * T < (1ll << 31);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct FwdArgs {
  const void *y, *bias, *gamma, *beta;
  void *out, *mean, *rstd;
  int B, C, T;
  float eps;
  bool rows;
  cudaStream_t stream;
};

struct BwdArgs {
  const void *g, *y, *bias, *gamma, *beta, *mean, *rstd;
  void *dx, *partial;
  int grid, B, C, T;  // grid: the blocks that write weight-gradient rows
  bool rows;
  cudaStream_t stream;
};

template <class Gelu, class E, bool kStats>
int launch_fwd(const FwdArgs& a) {
  const auto* bias = static_cast<const float*>(a.bias);
  const auto* gamma = static_cast<const float*>(a.gamma);
  const auto* beta = static_cast<const float*>(a.beta);
  auto* mean = static_cast<float*>(a.mean);
  auto* rstd = static_cast<float*>(a.rstd);
  if (a.rows) {
    const int n = a.B * a.T;
    fe_norm_rows_fwd_kernel<Gelu, E, kStats>
        <<<(n + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, a.stream>>>(
            static_cast<const E*>(a.y), bias, gamma, beta, static_cast<E*>(a.out), mean, rstd, n,
            a.C, a.eps);
    return cudaGetLastError();
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(fe_norm_fwd_kernel<Gelu, E, kStats>, fwd_smem<E>(kMaxC));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.T + kFrames - 1) / kFrames, a.B);
  fe_norm_fwd_kernel<Gelu, E, kStats><<<grid, kWarps * 32, fwd_smem<E>(a.C), a.stream>>>(
      static_cast<const typename Elem<E>::Raw*>(a.y), bias, gamma, beta, static_cast<E*>(a.out),
      mean, rstd, a.C, a.T, a.eps);
  return cudaGetLastError();
}

template <class Gelu, class E, bool kWgrad>
int launch_bwd(const BwdArgs& a) {
  const auto* bias = static_cast<const float*>(a.bias);
  const auto* gamma = static_cast<const float*>(a.gamma);
  const auto* beta = static_cast<const float*>(a.beta);
  const auto* mean = static_cast<const float*>(a.mean);
  const auto* rstd = static_cast<const float*>(a.rstd);
  auto* partial = static_cast<float*>(a.partial);
  if (a.rows) {
    const int n = a.B * a.T;
    const int smem = kWgrad ? rows_wgrad_smem(a.C) : 0;
    static bool rows_configured = false;
    if (kWgrad && !rows_configured) {
      cudaError_t err = allow_smem(fe_norm_rows_bwd_kernel<Gelu, E, kWgrad>,
                                   rows_wgrad_smem(kMaxC));
      if (err != cudaSuccess) return err;
      rows_configured = true;
    }
    const int grid = kWgrad ? a.grid : (n + kRowWarps - 1) / kRowWarps;
    fe_norm_rows_bwd_kernel<Gelu, E, kWgrad><<<grid, kRowWarps * 32, smem, a.stream>>>(
        static_cast<const E*>(a.g), static_cast<const E*>(a.y), bias, gamma, beta, mean, rstd,
        static_cast<E*>(a.dx), partial, n, a.C);
    return cudaGetLastError();
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(fe_norm_bwd_kernel<Gelu, E, kWgrad>, bwd_smem<E>(kMaxC));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid = kWgrad ? dim3(a.grid) : dim3((a.T + kFrames - 1) / kFrames, a.B);
  using Raw = typename Elem<E>::Raw;
  fe_norm_bwd_kernel<Gelu, E, kWgrad><<<grid, kWarps * 32, bwd_smem<E>(a.C), a.stream>>>(
      static_cast<const Raw*>(a.g), static_cast<const Raw*>(a.y), bias, gamma, beta, mean, rstd,
      static_cast<E*>(a.dx), partial, a.B, a.C, a.T);
  return cudaGetLastError();
}

template <class Gelu, class E>
int fwd_stats(const FwdArgs& a) {
  return a.mean ? launch_fwd<Gelu, E, true>(a) : launch_fwd<Gelu, E, false>(a);
}

template <class Gelu>
int fwd_typed(const FwdArgs& a, bool is_bf16) {
  return is_bf16 ? fwd_stats<Gelu, bf16>(a) : fwd_stats<Gelu, float>(a);
}

template <class Gelu, class E>
int bwd_wgrad(const BwdArgs& a) {
  return a.partial ? launch_bwd<Gelu, E, true>(a) : launch_bwd<Gelu, E, false>(a);
}

template <class Gelu>
int bwd_typed(const BwdArgs& a, bool is_bf16) {
  return is_bf16 ? bwd_wgrad<Gelu, bf16>(a) : bwd_wgrad<Gelu, float>(a);
}

}  // namespace
}  // namespace fenorm
}  // namespace paa

// y, out: contiguous (B, C, T), or (B, T, C) with channels_last, bfloat16
// (is_bf16) or float32; bias, gamma, beta: (C,) float32; mean, rstd: (B, T)
// float32, written when both are given (the backward's inputs), else both
// null. tanh: 1 for the tanh GELU, 0 for erf. With channels_last, y and out
// are 16-byte aligned.
extern "C" int paa_fe_norm_fwd(const void* y, const void* bias, const void* gamma,
                               const void* beta, void* out, void* mean, void* rstd, int B, int C,
                               int T, float eps, int tanh, int channels_last, int is_bf16,
                               void* stream) {
  using namespace paa::fenorm;
  if (!shape_ok(B, C, T) || (mean == nullptr) != (rstd == nullptr)) return cudaErrorInvalidValue;
  const FwdArgs a{y, bias, gamma, beta, out, mean, rstd, B, C, T, eps, channels_last != 0,
                  static_cast<cudaStream_t>(stream)};
  return tanh ? fwd_typed<TanhGelu>(a, is_bf16 != 0) : fwd_typed<ErfGelu>(a, is_bf16 != 0);
}

// g, y, dx: as y of the forward; bias, gamma, beta: (C,) float32; mean,
// rstd: the forward's (B, T) float32; partial: null, or (grid, 3, C) float32
// for the weight gradients' rows (Σ dz·x̂, Σ dz, Σ dx a block), grid ≥ 1.
extern "C" int paa_fe_norm_bwd(const void* g, const void* y, const void* bias, const void* gamma,
                               const void* beta, const void* mean, const void* rstd, void* dx,
                               void* partial, int grid, int B, int C, int T, int tanh,
                               int channels_last, int is_bf16, void* stream) {
  using namespace paa::fenorm;
  if (!shape_ok(B, C, T) || (partial != nullptr && grid < 1)) return cudaErrorInvalidValue;
  const BwdArgs a{g, y, bias, gamma, beta, mean, rstd, dx, partial, grid, B, C, T,
                  channels_last != 0, static_cast<cudaStream_t>(stream)};
  return tanh ? bwd_typed<TanhGelu>(a, is_bf16 != 0) : bwd_typed<ErfGelu>(a, is_bf16 != 0);
}
