// K2 — attention backward on Hopper, the register route: float32 (head dim
// 16 or 64) and bfloat16 with head dim 16. bfloat16 with head dim 64, the
// base and lv60 paths, runs in attention_bwd_sm90.cu.
//
// Replaces paa_tpu/ops/pallas/attention.py:_bwd_kernel (launched by
// _attend_bwd), and the backward of the stock Pallas flash_attention
// (paa_tpu/models/wav2vec2.py:_flash_attention, T >= 774; see
// attention_fwd.cu).
//
// It recomputes p = exp(s − lse) from (q, k, lse), with padded query rows
// and padded keys at p = 0, then dp = do·vᵀ, D = rowsum(do ∘ o),
// ds = p·(dp − D), dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do. p and ds are rounded
// to the input type before the three gradient products, as the TPU kernel
// rounds them.
//
// What bounds it on the H100: five T×T×d products, 2.5× the forward's
// operations, on the FMA units in float32 and the tensor cores in bf16; at
// the tiny preset's calls latency sets the time, as in the forward.
//
// Design: one launch, deterministic, no float atomics, no scratch. The grid
// (2·⌈T/32⌉, H, B) splits its blocks into two roles of one head each:
//   blockIdx.x <  ⌈T/32⌉: the block owns 32 keys and their k, v and dk, dv
//     accumulators, and streams the query tiles (q, do, and each query
//     row's lse and D, D computed as the tile is staged);
//   blockIdx.x >= ⌈T/32⌉: the block owns 32 query rows and their q, do, dq,
//     lse and D, and streams the key tiles (k, v).
// Both roles recompute s and dp for their pairs; p and ds stay in
// registers. Each block is the only writer of its rows, so no sum crosses
// blocks, and a row's splits merge by shuffles in a fixed order.
//   float32: 64 threads in row groups of 4 lanes, each group owning 2 rows
//     (attention_common.cuh), each lane with its slice of the owned rows'
//     operands and accumulators in registers (key role at d = 16: k, v, dk,
//     dv of both rows whole, 128 registers; at d = 64 a quarter of each). A
//     streamed row's slice serves both rows and both of their products.
//   bfloat16 (d = 16): 2 warps of 16 rows on mma.sync m16n8k16: sᵀ = k·qᵀ
//     and dpᵀ = v·doᵀ (key role) or s = q·kᵀ and dp = do·vᵀ (query role) in
//     accumulator registers, p and ds rounded to bf16 in place as the A
//     operands of dv += pᵀ·do, dk += dsᵀ·q, dq += ds·k.
// A row's D is computed by row_delta in both roles, so they agree to the bit.
#include "attention_common.cuh"

namespace paa {
namespace {

template <int D>
__global__ void __launch_bounds__(BwdRows<D>::kThreads, BwdRows<D>::kMinBlocks)
attn_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ lse, const float* __restrict__ dout,
                    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                    int T_len, int H) {
  using C = BwdRows<D>;
  constexpr int GD = C::GD, GS = C::GS, R = C::R, V4 = C::kV4, LD = C::kLd, NT = C::kThreads;
  // the streamed tile: q and do with their rows' lse and D (key role), or
  // k and v (query role)
  __shared__ __align__(16) float As[C::kTile * LD];
  __shared__ __align__(16) float Bs[C::kTile * LD];
  __shared__ float lse_s[C::kTile];
  __shared__ float delta_s[C::kTile];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const float* lse_h = lse + (static_cast<long>(b) * H + h) * T_len;
  const int n_blocks = (T_len + kBlockRows - 1) / kBlockRows;
  const bool key_role = blockIdx.x < n_blocks;
  const int split = (threadIdx.x / GD) % GS;
  const int d = threadIdx.x % GD;
  int row[R];
  long row_off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    row[r] = (key_role ? blockIdx.x : blockIdx.x - n_blocks) * kBlockRows +
             threadIdx.x / C::kLanes + r * C::kGroups;
    row_off[r] = base + row[r] * row_stride;
  }

  if (key_role) {
    float4 kr[R][V4], vr[R][V4], dka[R][V4], dva[R][V4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_slice<GD, V4>(kr[r], row[r] < T_len ? k + row_off[r] : nullptr, d);
      load_slice<GD, V4>(vr[r], row[r] < T_len ? v + row_off[r] : nullptr, d);
      zero_slice<V4>(dka[r]);
      zero_slice<V4>(dva[r]);
    }
    for (int q0 = 0; q0 < T_len; q0 += C::kTile) {
      __syncthreads();  // the previous tile is no longer read
      stage_rows<float, D, C::kTile, LD, NT>(As, q + base, row_stride, q0, T_len);
      stage_rows<float, D, C::kTile, LD, NT>(Bs, dout + base, row_stride, q0, T_len);
      for (int i = threadIdx.x; i < C::kTile; i += NT) {
        const bool ok = q0 + i < T_len;
        const long off = base + (q0 + i) * row_stride;
        lse_s[i] = ok ? lse_h[q0 + i] : 0.0f;
        delta_s[i] = ok ? row_delta<float, D>(dout + off, o + off) : 0.0f;
      }
      __syncthreads();
      const int steps = (min(C::kTile, T_len - q0) + GS - 1) / GS;
#pragma unroll 2
      for (int t = 0; t < steps; ++t) {
        const int j = split + GS * t;
        const float* qj = As + j * LD;
        const float* doj = Bs + j * LD;
        const bool ok = q0 + j < T_len;
        const float lse_j = lse_s[j], delta_j = delta_s[j];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float s = sum_dims<GD>(dot_shared<GD, V4>(kr[r], qj, d));
          const float dp = sum_dims<GD>(dot_shared<GD, V4>(vr[r], doj, d));
          const float p = ok ? exp_sub(s, lse_j) : 0.0f;
          axpy_shared<GD, V4>(dva[r], p, doj, d);
          axpy_shared<GD, V4>(dka[r], p * (dp - delta_j), qj, d);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum_splits<GD, GS, V4>(dka[r]);
      sum_splits<GD, GS, V4>(dva[r]);
      if (row[r] < T_len && split == 0) {
        store_slice<GD, V4>(dk + row_off[r], dka[r], 1.0f, d);
        store_slice<GD, V4>(dv + row_off[r], dva[r], 1.0f, d);
      }
    }
  } else {
    float4 qr[R][V4], dor[R][V4], dqa[R][V4];
    float lse_r[R], delta_r[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = row[r] < T_len;
      load_slice<GD, V4>(qr[r], live ? q + row_off[r] : nullptr, d);
      load_slice<GD, V4>(dor[r], live ? dout + row_off[r] : nullptr, d);
      zero_slice<V4>(dqa[r]);
      lse_r[r] = live ? lse_h[row[r]] : 0.0f;
      delta_r[r] = live ? row_delta<float, D>(dout + row_off[r], o + row_off[r]) : 0.0f;
    }
    for (int k0 = 0; k0 < T_len; k0 += C::kTile) {
      __syncthreads();
      stage_rows<float, D, C::kTile, LD, NT>(As, k + base, row_stride, k0, T_len);
      stage_rows<float, D, C::kTile, LD, NT>(Bs, v + base, row_stride, k0, T_len);
      __syncthreads();
      const int steps = (min(C::kTile, T_len - k0) + GS - 1) / GS;
#pragma unroll 2
      for (int t = 0; t < steps; ++t) {
        const int j = split + GS * t;
        const float* kj = As + j * LD;
        const bool ok = k0 + j < T_len;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float s = sum_dims<GD>(dot_shared<GD, V4>(qr[r], kj, d));
          const float dp = sum_dims<GD>(dot_shared<GD, V4>(dor[r], Bs + j * LD, d));
          const float p = ok ? exp_sub(s, lse_r[r]) : 0.0f;
          axpy_shared<GD, V4>(dqa[r], p * (dp - delta_r[r]), kj, d);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum_splits<GD, GS, V4>(dqa[r]);
      if (row[r] < T_len && split == 0) store_slice<GD, V4>(dq + row_off[r], dqa[r], 1.0f, d);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const float* __restrict__ lse, const bf16* __restrict__ dout,
                     bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                     int T_len, int H) {
  constexpr int D = 16;
  constexpr int kGroups = kMmaTile / 16;
  __shared__ __align__(16) bf16 As[kMmaTile * kMmaLd];
  __shared__ __align__(16) bf16 Bs[kMmaTile * kMmaLd];
  __shared__ float lse_s[kMmaTile];
  __shared__ float delta_s[kMmaTile];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const float* lse_h = lse + (static_cast<long>(b) * H + h) * T_len;
  const int n_blocks = (T_len + kBlockRows - 1) / kBlockRows;
  const bool key_role = blockIdx.x < n_blocks;
  const int row0 = (key_role ? blockIdx.x : blockIdx.x - n_blocks) * kBlockRows +
                   (threadIdx.x / 32) * 16;
  const int col = 2 * (lane % 4);  // this lane's first column of an 8-wide accumulator

  if (key_role) {
    // rows of the products are this warp's 16 keys, columns the queries
    uint32_t ka[4], va[4];
    load_a(ka, k + base, row_stride, row0, T_len, lane);
    load_a(va, v + base, row_stride, row0, T_len, lane);
    float dka[2][4] = {}, dva[2][4] = {};
    for (int q0 = 0; q0 < T_len; q0 += kMmaTile) {
      __syncthreads();
      stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(As, q + base, row_stride, q0, T_len);
      stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(Bs, dout + base, row_stride, q0, T_len);
      for (int r = threadIdx.x; r < kMmaTile; r += kMmaThreads) {
        const bool ok = q0 + r < T_len;
        const long off = base + (q0 + r) * row_stride;
        lse_s[r] = ok ? lse_h[q0 + r] : 0.0f;
        delta_s[r] = ok ? row_delta<bf16, D>(dout + off, o + off) : 0.0f;
      }
      __syncthreads();
      const int groups = (min(kMmaTile, T_len - q0) + 15) / 16;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (g < groups) {
          float s[2][4] = {}, dp[2][4] = {};
          uint32_t bq[4], bdo[4];
          b_rows_n(bq, As, 16 * g, lane);
          b_rows_n(bdo, Bs, 16 * g, lane);
          mma_bf16(s[0], ka, bq[0], bq[1]);
          mma_bf16(s[1], ka, bq[2], bq[3]);
          mma_bf16(dp[0], va, bdo[0], bdo[1]);
          mma_bf16(dp[1], va, bdo[2], bdo[3]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 16 * g + 8 * n + col + (i & 1);  // query in the tile
              const float p = q0 + j < T_len ? exp_sub(s[n][i], lse_s[j]) : 0.0f;
              s[n][i] = p;
              dp[n][i] = p * (dp[n][i] - delta_s[j]);
            }
          }
          uint32_t pa[4], dsa[4], bdo_k[4], bq_k[4];
          acc_to_a(pa, s[0], s[1]);    // pᵀ, rounded to bf16
          acc_to_a(dsa, dp[0], dp[1]);  // dsᵀ, rounded to bf16
          b_rows_k(bdo_k, Bs, 16 * g, lane);
          b_rows_k(bq_k, As, 16 * g, lane);
          mma_bf16(dva[0], pa, bdo_k[0], bdo_k[1]);
          mma_bf16(dva[1], pa, bdo_k[2], bdo_k[3]);
          mma_bf16(dka[0], dsa, bq_k[0], bq_k[1]);
          mma_bf16(dka[1], dsa, bq_k[2], bq_k[3]);
        }
      }
    }
    store_acc(dk + base, row_stride, row0, T_len, dka, 1.0f, 1.0f, lane);
    store_acc(dv + base, row_stride, row0, T_len, dva, 1.0f, 1.0f, lane);
  } else {
    // rows of the products are this warp's 16 queries, columns the keys
    uint32_t qa[4], doa[4];
    load_a(qa, q + base, row_stride, row0, T_len, lane);
    load_a(doa, dout + base, row_stride, row0, T_len, lane);
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + lane / 4 + 8 * r;
      const long off = base + row * row_stride;
      lse_r[r] = row < T_len ? lse_h[row] : 0.0f;
      delta_r[r] = row < T_len ? row_delta<bf16, D>(dout + off, o + off) : 0.0f;
    }
    float dqa[2][4] = {};
    for (int k0 = 0; k0 < T_len; k0 += kMmaTile) {
      __syncthreads();
      stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(As, k + base, row_stride, k0, T_len);
      stage_rows<bf16, D, kMmaTile, kMmaLd, kMmaThreads>(Bs, v + base, row_stride, k0, T_len);
      __syncthreads();
      const int groups = (min(kMmaTile, T_len - k0) + 15) / 16;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (g < groups) {
          float s[2][4] = {}, dp[2][4] = {};
          uint32_t bk[4], bv[4];
          b_rows_n(bk, As, 16 * g, lane);
          b_rows_n(bv, Bs, 16 * g, lane);
          mma_bf16(s[0], qa, bk[0], bk[1]);
          mma_bf16(s[1], qa, bk[2], bk[3]);
          mma_bf16(dp[0], doa, bv[0], bv[1]);
          mma_bf16(dp[1], doa, bv[2], bv[3]);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int key = k0 + 16 * g + 8 * n + col + (i & 1);
              const float p = key < T_len ? exp_sub(s[n][i], lse_r[i / 2]) : 0.0f;
              dp[n][i] = p * (dp[n][i] - delta_r[i / 2]);
            }
          }
          uint32_t dsa[4], bk_k[4];
          acc_to_a(dsa, dp[0], dp[1]);  // ds, rounded to bf16
          b_rows_k(bk_k, As, 16 * g, lane);
          mma_bf16(dqa[0], dsa, bk_k[0], bk_k[1]);
          mma_bf16(dqa[1], dsa, bk_k[2], bk_k[3]);
        }
      }
    }
    store_acc(dq + base, row_stride, row0, T_len, dqa, 1.0f, 1.0f, lane);
  }
}

template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                           const void* lse, const void* dout, void* dq, void* dk, void* dv, int B,
                           int T_len, int H, cudaStream_t stream) {
  dim3 grid(2 * ((T_len + kBlockRows - 1) / kBlockRows), H, B);
  attn_bwd_f32_kernel<D><<<grid, BwdRows<D>::kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), T_len, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paa

// q, k, v, o, do, dq, dk, dv: (B, T, H·D) contiguous, float32 with D 16 or
// 64, or bfloat16 with D 16 (bfloat16 with D = 64 runs in
// attention_bwd_sm90.cu); lse: (B, H, T) float32 from the forward.
extern "C" int paa_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                 int B, int T_len, int H, int D, int is_bf16, void* stream) {
  using namespace paa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D != 16) return cudaErrorInvalidValue;
    dim3 grid(2 * ((T_len + kBlockRows - 1) / kBlockRows), H, B);
    attn_bwd_bf16_kernel<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const float*>(lse),
        static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), T_len, H);
    return cudaGetLastError();
  }
  if (D == 64) return launch_bwd_f32<64>(q, k, v, o, lse, dout, dq, dk, dv, B, T_len, H, s);
  if (D == 16) return launch_bwd_f32<16>(q, k, v, o, lse, dout, dq, dk, dv, B, T_len, H, s);
  return cudaErrorInvalidValue;
}
