// K1 — attention forward on Hopper, the register route: float32 (head dim
// 16 or 64) and bfloat16 with head dim 16. bfloat16 with head dim 64, the
// base and lv60 paths, runs in attention_fwd_sm90.cu.
//
// Replaces paa_tpu/ops/pallas/attention.py:_fwd_kernel (launched by
// _attend_fwd), and the forward of the stock Pallas flash_attention that
// paa_tpu/models/wav2vec2.py:_flash_attention runs from T = 774 frames on
// (K4): the keys stream past in tiles under an online softmax, so one design
// covers any T and K4 needs no kernel of its own.
//
// Per (batch, head): s = q·kᵀ (q pre-scaled), keys at or past T masked to
// -1e30, softmax in f32, o = p·v; it also stores the row logsumexp
// lse = m + log l, the one residual the backward needs.
//
// What bounds it on the H100: 4·B·H·T²·d operations, on the FMA units
// (67 TFLOP/s) in float32 and on the tensor cores in bf16. At the tiny
// preset's calls (B = 32, T ≈ 150, H = 4, d = 16) the work is so small that
// latency, not either rate, sets the time: the design keeps every operand a
// step needs in registers and puts many warps on each SM to hide it.
//
// Design: grid (⌈T/32⌉, H, B); a block owns 32 query rows of one head, read
// from the strided (B, T, H·d) layout in place, and walks the keys in tiles
// staged to shared memory (K and V only).
//   float32: row groups of 4 lanes (attention_common.cuh, FwdRows). d = 16:
//     64 threads, each group owning 2 rows; each lane holds both rows' q and
//     o accumulators whole (64 registers) and takes a quarter of each key
//     tile, reading a key once for both rows. d = 64: 128 threads, one row a
//     group, 2 lanes splitting the dims (32 + 32 registers) and 2 the keys.
//     A lane computes its scores of a tile into registers, updates each
//     row's running max and sum and accumulates p·v; the row's key splits
//     merge once at the end by shuffles.
//   bfloat16 (d = 16): 2 warps of 16 rows; q·kᵀ and p·v on mma.sync
//     m16n8k16 (f32 accumulation), the scores in accumulator registers, p
//     rounded to bf16 in place as the A operand of p·v. 16-key groups past T
//     are skipped, so T = 152 runs 152 keys, not 192.
// p is rounded to the input type before p·v, as the TPU kernel rounds p/l.
// o is written in the input type, lse as f32 (B, H, T); query rows at or
// past T are never stored.
#include "attention_common.cuh"

namespace paa {
namespace {

template <int D>
__global__ void __launch_bounds__(FwdRows<D>::kThreads, FwdRows<D>::kMinBlocks)
attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    int T_len, int H) {
  using C = FwdRows<D>;
  constexpr int GD = C::GD, GS = C::GS, R = C::R, V4 = C::kV4, LD = C::kLd;
  __shared__ __align__(16) float Ks[C::kTile * LD];
  __shared__ __align__(16) float Vs[C::kTile * LD];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const int split = (threadIdx.x / GD) % GS;
  const int d = threadIdx.x % GD;
  int row[R];
  float4 qr[R][V4], acc[R][V4];
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = blockIdx.x * kBlockRows + threadIdx.x / C::kLanes + r * C::kGroups;
    load_slice<GD, V4>(qr[r], row[r] < T_len ? q + base + row[r] * row_stride : nullptr, d);
    zero_slice<V4>(acc[r]);
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int k0 = 0; k0 < T_len; k0 += C::kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage_rows<float, D, C::kTile, LD, C::kThreads>(Ks, k + base, row_stride, k0, T_len);
    stage_rows<float, D, C::kTile, LD, C::kThreads>(Vs, v + base, row_stride, k0, T_len);
    __syncthreads();
    // steps of this tile that hold a key before T (the same for the block)
    const int steps = (min(C::kTile, T_len - k0) + GS - 1) / GS;
    float sc[R][C::kPer];
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
#pragma unroll
    for (int t = 0; t < C::kPer; ++t) {
      if (t < steps) {
        const int j = split + GS * t;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = sum_dims<GD>(dot_shared<GD, V4>(qr[r], Ks + j * LD, d));
          sc[r][t] = k0 + j < T_len ? x : kMaskScore;
          mx[r] = fmaxf(mx[r], sc[r][t]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = exp_sub(m[r], m_new);
      m[r] = m_new;
      l[r] *= alpha;
      scale_slice<V4>(acc[r], alpha);
    }
#pragma unroll
    for (int t = 0; t < C::kPer; ++t) {
      if (t < steps) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float p = exp_sub(sc[r][t], m[r]);
          l[r] += p;
          axpy_shared<GD, V4>(acc[r], p, Vs + (split + GS * t) * LD, d);
        }
      }
    }
  }

  // merge each row's key splits: a split that saw only padded keys has
  // m = -1e30 and weighs exp(-1e30 - m_row) = 0
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float m_row = max_splits<GD, GS>(m[r]);
    const float w = exp_sub(m[r], m_row);
    const float l_row = sum_splits<GD, GS>(l[r] * w);
    scale_slice<V4>(acc[r], w);
    sum_splits<GD, GS, V4>(acc[r]);
    if (row[r] < T_len && split == 0) {
      store_slice<GD, V4>(o + base + row[r] * row_stride, acc[r], 1.0f / l_row, d);
      if (d == 0) lse[(static_cast<long>(b) * H + h) * T_len + row[r]] = m_row + logf(l_row);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     int T_len, int H) {
  constexpr int D = 16;
  __shared__ __align__(16) bf16 Ks[kMmaTile * kMmaLd];
  __shared__ __align__(16) bf16 Vs[kMmaTile * kMmaLd];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const int row0 = blockIdx.x * kBlockRows + (threadIdx.x / 32) * 16;

  uint32_t qa[4];
  load_a(qa, q + base, row_stride, row0, T_len, lane);
  float acc[2][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this lane's share of the row sums

  for (int k0 = 0; k0 < T_len; k0 += kMmaTile) {
    __syncthreads();
    stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(Ks, k + base, row_stride, k0, T_len);
    stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(Vs, v + base, row_stride, k0, T_len);
    __syncthreads();
    const int groups = (min(kMmaTile, T_len - k0) + 15) / 16;  // 16-key groups before T
    float s[kMmaTile / 8][4];
#pragma unroll
    for (int g = 0; g < kMmaTile / 16; ++g) {
      if (g < groups) {
        uint32_t bk[4];
        b_rows_n(bk, Ks, 16 * g, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[2 * g][i] = s[2 * g + 1][i] = 0.0f;
        mma_bf16(s[2 * g], qa, bk[0], bk[1]);
        mma_bf16(s[2 * g + 1], qa, bk[2], bk[3]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kMmaTile / 8; ++n) {
      if (n / 2 < groups) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + 8 * n + 2 * (lane % 4) + (i & 1) >= T_len) s[n][i] = kMaskScore;
          mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp_sub(m[r], m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] *= alpha[i / 2];
    }
#pragma unroll
    for (int g = 0; g < kMmaTile / 16; ++g) {
      if (g < groups) {
#pragma unroll
        for (int n = 2 * g; n < 2 * g + 2; ++n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[n][i] = exp_sub(s[n][i], m[i / 2]);
            l[i / 2] += s[n][i];
          }
        }
        uint32_t pa[4], bv[4];
        acc_to_a(pa, s[2 * g], s[2 * g + 1]);  // p, rounded to bf16
        b_rows_k(bv, Vs, 16 * g, lane);
        mma_bf16(acc[0], pa, bv[0], bv[1]);
        mma_bf16(acc[1], pa, bv[2], bv[3]);
      }
    }
  }

  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_acc(o + base, row_stride, row0, T_len, acc, 1.0f / la, 1.0f / lb, lane);
  if (lane % 4 == 0) {
    float* lse_out = lse + (static_cast<long>(b) * H + h) * T_len;
    const int r = row0 + lane / 4;
    if (r < T_len) lse_out[r] = m[0] + logf(la);
    if (r + 8 < T_len) lse_out[r + 8] = m[1] + logf(lb);
  }
}

template <int D>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                           int T_len, int H, cudaStream_t stream) {
  dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H, B);
  attn_fwd_f32_kernel<D><<<grid, FwdRows<D>::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), T_len, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paa

// q, k, v, o: (B, T, H·D) contiguous, float32 (is_bf16 = 0) with D 16 or
// 64, or bfloat16 (is_bf16 = 1) with D 16; lse: (B, H, T) float32.
// bfloat16 with D = 64 runs in attention_fwd_sm90.cu.
extern "C" int paa_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int B, int T_len, int H, int D, int is_bf16, void* stream) {
  using namespace paa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D != 16) return cudaErrorInvalidValue;
    dim3 grid((T_len + kBlockRows - 1) / kBlockRows, H, B);
    attn_fwd_bf16_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), T_len, H);
    return cudaGetLastError();
  }
  if (D == 64) return launch_fwd_f32<64>(q, k, v, o, lse, B, T_len, H, s);
  if (D == 16) return launch_fwd_f32<16>(q, k, v, o, lse, B, T_len, H, s);
  return cudaErrorInvalidValue;
}
