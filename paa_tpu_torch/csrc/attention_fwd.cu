// K1 — attention forward on Hopper.
//
// Replaces paa_tpu/ops/pallas/attention.py:_fwd_kernel (launched by
// _attend_fwd). Per (batch, head): s = q·kᵀ (q pre-scaled), keys at or past
// T masked to -1e30, softmax in f32, o = p·v; it also stores the row
// logsumexp lse = m + log l, the one residual the backward needs.
//
// What bounds it on the H100: at the main-path shape (B=64, T=499, H=12,
// d=64, bf16) one layer's forward is 4·B·H·T²·d ≈ 49 GFLOP against
// ≈ 0.2 GB of q/k/v/o traffic, so it is compute-bound, and the score tile
// cannot be kept whole: the TPU kernel holds a 512×512 f32 tile per head
// in VMEM, an SM has 227 KB of shared memory.
//
// Design: grid (⌈T/64⌉, H, B); a block of 4 warps owns 64 query rows of one
// head, read straight from the strided (B, T, H·d) layout (row stride H·d,
// no transposes in device memory). It walks the keys in tiles of 64 with an
// online softmax: running max m and sum l per row, the f32 output
// accumulator rescaled by exp(m_old − m_new) before each p·v. Both products
// run on the tensor cores (WMMA bf16, f32 accumulation) for bf16 inputs and
// as FMA loops for f32 inputs. p is rounded to the input type before p·v,
// as the TPU kernel rounds p/l. o is written in the input type, lse as f32
// (B, H, T); query rows at or past T are never stored.
#include "attention_common.cuh"

namespace paa {
namespace {

template <typename T, int D>
constexpr int fwd_smem_bytes() {
  return (kBQ + 2 * kBK) * ld_in<T, D>() * sizeof(T)  // Q, K, V tiles
         + kBQ * ld_score() * sizeof(float)     // scores
         + kBQ * ld_prob<T>() * sizeof(T)       // probabilities
         + kBQ * ld_acc<D>() * sizeof(float)    // output accumulator
         + 2 * kBQ * sizeof(float);             // m, l
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int T_len, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDT = ld_in<T, D>();
  constexpr int LDS = ld_score();
  constexpr int LDP = ld_prob<T>();
  constexpr int LDO = ld_acc<D>();
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * LDT;
  T* Vs = Ks + kBK * LDT;
  float* S = reinterpret_cast<float*>(Vs + kBK * LDT);
  T* P = reinterpret_cast<T*>(S + kBQ * LDS);
  float* O = reinterpret_cast<float*>(P + kBQ * LDP);
  float* m_s = O + kBQ * LDO;
  float* l_s = m_s + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = static_cast<long>(H) * D;
  const long base = static_cast<long>(b) * T_len * row_stride + static_cast<long>(h) * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_rows<T, D, kBQ>(Qs, LDT, q + base, row_stride, q0, T_len);
  for (int i = threadIdx.x; i < kBQ * LDO; i += kThreads) O[i] = 0.0f;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }

  for (int k0 = 0; k0 < T_len; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_rows<T, D, kBK>(Ks, LDT, k + base, row_stride, k0, T_len);
    load_rows<T, D, kBK>(Vs, LDT, v + base, row_stride, k0, T_len);
    __syncthreads();
    block_gemm<T, RowMajor, ColMajor, kBQ, kBK, D>(S, LDS, Qs, LDT, Ks, LDT, false);  // q·kᵀ
    __syncthreads();
    for (int r = warp; r < kBQ; r += kWarps) {
      float sv[kBK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int c = lane + 32 * i;
        sv[i] = (k0 + c < T_len) ? S[r * LDS + c] : kMaskScore;
        mx = fmaxf(mx, sv[i]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const float p = expf(sv[i] - m_new);
        P[r * LDP + lane + 32 * i] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < D; c += 32) O[r * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    block_gemm<T, RowMajor, RowMajor, kBQ, D, kBK>(O, LDO, P, LDP, Vs, LDT, true);  // o += p·v
  }
  __syncthreads();

  // o = acc / l; lse = m + log l. m_s is reused as 1/l for the store.
  float* lse_out = lse + (static_cast<long>(b) * H + h) * T_len;
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const float l = l_s[r];
    if (q0 + r < T_len) lse_out[q0 + r] = m_s[r] + logf(l);
    l_s[r] = 1.0f / l;
  }
  __syncthreads();
  store_rows<T, D, kBQ>(o + base, row_stride, q0, T_len, O, LDO, l_s);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                       int T_len, int H, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<T, D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(attn_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  attn_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), T_len, H);
  return cudaGetLastError();
}

}  // namespace
}  // namespace paa

// q, k, v, o: (B, T, H·D) contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1); lse: (B, H, T) float32. D is 16 or 64.
extern "C" int paa_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int B, int T_len, int H, int D, int is_bf16, void* stream) {
  using namespace paa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (D == 64) return launch_fwd<bf16, 64>(q, k, v, o, lse, B, T_len, H, s);
    if (D == 16) return launch_fwd<bf16, 16>(q, k, v, o, lse, B, T_len, H, s);
  } else {
    if (D == 64) return launch_fwd<float, 64>(q, k, v, o, lse, B, T_len, H, s);
    if (D == 16) return launch_fwd<float, 16>(q, k, v, o, lse, B, T_len, H, s);
  }
  return cudaErrorInvalidValue;
}
