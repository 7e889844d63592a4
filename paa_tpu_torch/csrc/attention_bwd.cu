// K2 — attention backward on Hopper.
//
// Replaces paa_tpu/ops/pallas/attention.py:_bwd_kernel (launched by
// _attend_bwd). It recomputes p = exp(s − lse) from (q, k, lse), with padded
// query rows and padded keys at p = 0, then dp = do·vᵀ, ds = p·(dp − D),
// dq = ds·k, dk = dsᵀ·q, dv = pᵀ·do. p and ds are rounded to the input type
// before the three gradient products, as the TPU kernel rounds them.
//
// What bounds it on the H100: 2.5× the forward's products (five T×T×d
// products against two), so it is compute-bound like K1, and a T×T tile per
// head does not fit in shared memory.
//
// Design: three launches, deterministic, no float atomics.
//   1. delta: D = rowsum(do ∘ o) per (b, h, row), f32 (B, H, T). It equals
//      Σ_j p·dp (the TPU kernel's form) in exact arithmetic, and costs one
//      pass over do and o instead of a product per key tile.
//   2. dkdv: grid (⌈T/64⌉, H, B); a block owns 64 keys of one head, walks
//      every query tile, recomputes s and dp, and accumulates dk and dv in
//      f32 shared memory.
//   3. dq: grid (⌈T/64⌉, H, B); a block owns 64 query rows, walks every key
//      tile, recomputes s and dp, and accumulates dq.
// Each block is the only writer of its rows, so no sum crosses blocks.
// Products run on the tensor cores (WMMA bf16, f32 accumulation) for bf16
// and as FMA loops for f32.
#include "attention_common.cuh"

namespace paa {
namespace {

// D[b, h, t] = Σ_c do[b, t, h, c] · o[b, t, h, c]; one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int T_len, int H) {
  const long row = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long>(B) * T_len * H) return;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc += to_f<T>(dout[row * D + c]) * to_f<T>(o[row * D + c]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long bt = row / H;
    const int t = static_cast<int>(bt % T_len);
    const int b = static_cast<int>(bt / T_len);
    delta[(static_cast<long>(b) * H + h) * T_len + t] = acc;
  }
}

// From S = q·kᵀ and dP = do·vᵀ of one (query tile, key tile) pair, write
// P = round(p) and dS = round(p·(dp − D)) to shared memory.
template <typename T>
__device__ __forceinline__ void probs_and_dscores(T* P, T* dS, const float* S, const float* dP,
                                                  const float* lse_s, const float* delta_s,
                                                  int q0, int k0, int T_len) {
  constexpr int LDS = ld_score();
  constexpr int LDP = ld_prob<T>();
  for (int i = threadIdx.x; i < kBQ * kBK; i += kThreads) {
    const int r = i / kBK;
    const int c = i % kBK;
    const bool valid = (q0 + r < T_len) && (k0 + c < T_len);
    const float p = valid ? expf(S[r * LDS + c] - lse_s[r]) : 0.0f;
    P[r * LDP + c] = from_f<T>(p);
    dS[r * LDP + c] = from_f<T>(p * (dP[r * LDS + c] - delta_s[r]));
  }
}

// lse and D of query rows [q0, q0 + BQ) into shared memory (0 past T).
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, const float* lse,
                                               const float* delta, int q0, int T_len) {
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool ok = q0 + r < T_len;
    lse_s[r] = ok ? lse[q0 + r] : 0.0f;
    delta_s[r] = ok ? delta[q0 + r] : 0.0f;
  }
}

template <typename T, int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kBK + 2 * kBQ) * ld_in<T, D>() * sizeof(T)  // K, V, Q, dO tiles
         + 2 * kBQ * ld_score() * sizeof(float)           // S, dP
         + 2 * kBQ * ld_prob<T>() * sizeof(T)             // P, dS
         + 2 * kBK * ld_acc<D>() * sizeof(float)          // dK, dV accumulators
         + 2 * kBQ * sizeof(float);                       // lse, D
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDT = ld_in<T, D>();
  constexpr int LDS = ld_score();
  constexpr int LDP = ld_prob<T>();
  constexpr int LDA = ld_acc<D>();
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBK * LDT;
  T* Qs = Vs + kBK * LDT;
  T* dOs = Qs + kBQ * LDT;
  float* S = reinterpret_cast<float*>(dOs + kBQ * LDT);
  float* dP = S + kBQ * LDS;
  T* P = reinterpret_cast<T*>(dP + kBQ * LDS);
  T* dS = P + kBQ * LDP;
  float* dK = reinterpret_cast<float*>(dS + kBQ * LDP);
  float* dV = dK + kBK * LDA;
  float* lse_s = dV + kBK * LDA;
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const long stat_base = (static_cast<long>(b) * H + h) * T_len;

  load_rows<T, D, kBK>(Ks, LDT, k + base, row_stride, k0, T_len);
  load_rows<T, D, kBK>(Vs, LDT, v + base, row_stride, k0, T_len);
  for (int i = threadIdx.x; i < kBK * LDA; i += kThreads) {
    dK[i] = 0.0f;
    dV[i] = 0.0f;
  }

  for (int q0 = 0; q0 < T_len; q0 += kBQ) {
    __syncthreads();  // the previous query tile is no longer read
    load_rows<T, D, kBQ>(Qs, LDT, q + base, row_stride, q0, T_len);
    load_rows<T, D, kBQ>(dOs, LDT, dout + base, row_stride, q0, T_len);
    load_row_stats(lse_s, delta_s, lse + stat_base, delta + stat_base, q0, T_len);
    __syncthreads();
    block_gemm<T, RowMajor, ColMajor, kBQ, kBK, D>(S, LDS, Qs, LDT, Ks, LDT, false);    // q·kᵀ
    block_gemm<T, RowMajor, ColMajor, kBQ, kBK, D>(dP, LDS, dOs, LDT, Vs, LDT, false);  // do·vᵀ
    __syncthreads();
    probs_and_dscores<T>(P, dS, S, dP, lse_s, delta_s, q0, k0, T_len);
    __syncthreads();
    block_gemm<T, ColMajor, RowMajor, kBK, D, kBQ>(dV, LDA, P, LDP, dOs, LDT, true);  // dv += pᵀ·do
    block_gemm<T, ColMajor, RowMajor, kBK, D, kBQ>(dK, LDA, dS, LDP, Qs, LDT, true);  // dk += dsᵀ·q
  }
  __syncthreads();
  store_rows<T, D, kBK>(dk + base, row_stride, k0, T_len, dK, LDA, nullptr);
  store_rows<T, D, kBK>(dv + base, row_stride, k0, T_len, dV, LDA, nullptr);
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  return (2 * kBQ + 2 * kBK) * ld_in<T, D>() * sizeof(T)  // Q, dO, K, V tiles
         + 2 * kBQ * ld_score() * sizeof(float)           // S, dP
         + 2 * kBQ * ld_prob<T>() * sizeof(T)             // P (unused by dq), dS
         + kBQ * ld_acc<D>() * sizeof(float)              // dQ accumulator
         + 2 * kBQ * sizeof(float);                       // lse, D
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int T_len, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDT = ld_in<T, D>();
  constexpr int LDS = ld_score();
  constexpr int LDP = ld_prob<T>();
  constexpr int LDA = ld_acc<D>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * LDT;
  T* Ks = dOs + kBQ * LDT;
  T* Vs = Ks + kBK * LDT;
  float* S = reinterpret_cast<float*>(Vs + kBK * LDT);
  float* dP = S + kBQ * LDS;
  T* P = reinterpret_cast<T*>(dP + kBQ * LDS);
  T* dS = P + kBQ * LDP;
  float* dQ = reinterpret_cast<float*>(dS + kBQ * LDP);
  float* lse_s = dQ + kBQ * LDA;
  float* delta_s = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const long stat_base = (static_cast<long>(b) * H + h) * T_len;

  load_rows<T, D, kBQ>(Qs, LDT, q + base, row_stride, q0, T_len);
  load_rows<T, D, kBQ>(dOs, LDT, dout + base, row_stride, q0, T_len);
  load_row_stats(lse_s, delta_s, lse + stat_base, delta + stat_base, q0, T_len);
  for (int i = threadIdx.x; i < kBQ * LDA; i += kThreads) dQ[i] = 0.0f;

  for (int k0 = 0; k0 < T_len; k0 += kBK) {
    __syncthreads();  // the previous key tile is no longer read
    load_rows<T, D, kBK>(Ks, LDT, k + base, row_stride, k0, T_len);
    load_rows<T, D, kBK>(Vs, LDT, v + base, row_stride, k0, T_len);
    __syncthreads();
    block_gemm<T, RowMajor, ColMajor, kBQ, kBK, D>(S, LDS, Qs, LDT, Ks, LDT, false);    // q·kᵀ
    block_gemm<T, RowMajor, ColMajor, kBQ, kBK, D>(dP, LDS, dOs, LDT, Vs, LDT, false);  // do·vᵀ
    __syncthreads();
    probs_and_dscores<T>(P, dS, S, dP, lse_s, delta_s, q0, k0, T_len);
    __syncthreads();
    block_gemm<T, RowMajor, RowMajor, kBQ, D, kBK>(dQ, LDA, dS, LDP, Ks, LDT, true);  // dq += ds·k
  }
  __syncthreads();
  store_rows<T, D, kBQ>(dq + base, row_stride, q0, T_len, dQ, LDA, nullptr);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* lse, const void* dout, void* dq, void* dk, void* dv,
                       void* delta, int B, int T_len, int H, cudaStream_t stream) {
  constexpr int smem_kv = dkdv_smem_bytes<T, D>();
  constexpr int smem_q = dq_smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(attn_bwd_dkdv_kernel<T, D>, smem_kv);
    if (err == cudaSuccess) err = allow_smem(attn_bwd_dq_kernel<T, D>, smem_q);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lset = static_cast<const float*>(lse);
  float* deltat = static_cast<float*>(delta);

  const long rows = static_cast<long>(B) * T_len * H;
  attn_bwd_delta_kernel<T, D><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
                                stream>>>(static_cast<const T*>(o), dot, deltat, B, T_len, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid((T_len + kBK - 1) / kBK, H, B);
  attn_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem_kv, stream>>>(
      qt, kt, vt, dot, lset, deltat, static_cast<T*>(dk), static_cast<T*>(dv), T_len, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((T_len + kBQ - 1) / kBQ, H, B);
  attn_bwd_dq_kernel<T, D><<<grid_q, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, lset, deltat, static_cast<T*>(dq), T_len, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paa

// q, k, v, o, do, dq, dk, dv: (B, T, H·D) contiguous, float32 or bfloat16;
// lse: (B, H, T) float32 from the forward; delta: (B, H, T) float32 scratch.
extern "C" int paa_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                 void* delta, int B, int T_len, int H, int D, int is_bf16,
                                 void* stream) {
  using namespace paa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch_bwd<bf16, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, T_len, H, s);
    if (D == 16) return launch_bwd<bf16, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, T_len, H, s);
  } else {
    if (D == 64) return launch_bwd<float, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, T_len, H, s);
    if (D == 16) return launch_bwd<float, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, T_len, H, s);
  }
  return cudaErrorInvalidValue;
}
