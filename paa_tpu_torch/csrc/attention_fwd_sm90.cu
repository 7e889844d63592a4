// K1 — attention forward on Hopper, bf16 with head dim 64 (the base and
// lv60 paths). The float32 and head-dim-16 routes stay in attention_fwd.cu.
//
// Replaces paa_tpu/ops/pallas/attention.py:_fwd_kernel (launched by
// _attend_fwd), and the forward of the stock Pallas flash_attention that
// paa_tpu/models/wav2vec2.py:_flash_attention runs from T = 774 on (K4).
// Same function as attention_fwd.cu: s = q·kᵀ (q pre-scaled), keys at or
// past T masked to −∞, softmax in f32 with p rounded to bf16 before p·v,
// o in bf16, lse = m + log l in f32 (B, H, T); query rows at or past T are
// never stored.
//
// What bounds it on the H100: 4·B·H·T²·d operations against about
// 4·B·T·H·d·2 bytes, so the tensor cores: 0.0495 ms at base's shape
// (64, 499, 12, 64) and 0.132 ms at the lv60 microbatch (32, 999, 16, 64)
// at 989 TFLOP/s. The WMMA kernel it replaces staged every product, the
// scores and the accumulator through shared memory and ran at 4 % of that.
//
// Design: a block owns 128 query rows of one (batch, head): grid
// (⌈T/128⌉, H, B), 288 threads.
//   - Warp 8 is the producer. One lane loads the Q tile once and then every
//     K/V tile of 128 keys by TMA (3-D tensor maps over the (B, T, H·64)
//     layout, 128-byte swizzle, zero fill past T) into a ring of 4 stages
//     with full/empty mbarriers, so that later tiles load while tiles j−1
//     and j are multiplied (tools/attention_variants.py times 2 and 3).
//   - Warpgroups 0 and 1 are consumers, 64 query rows each. Per key tile:
//     S = Q·Kᵀ on wgmma m64n128k16 (Q and K from shared memory, K-major),
//     the online softmax on S in registers (exp2 with log2 e folded into
//     the scale, row max and sum across the 4 lanes of a row by shuffles),
//     then O += P·V on wgmma m64n64k16 with P converted to bf16 in place as
//     the register A operand and V MN-major (the transpose bit). S, P, O
//     and the row statistics stay in registers for the whole key loop.
//     The loop is software-pipelined: S_j and P_{j−1}·V_{j−1} are issued
//     together, so the softmax of tile j runs beside the previous tile's
//     P·V; it gives the same bits as the unpipelined loop.
//   The two warpgroups share each K/V tile, which halves the loads per
// product against a 64-row block, and one's softmax can run beside the
// other's wgmma. At d = 64 the exp2 of the softmax (16 a clock per SM) takes
// about as many cycles as the two products (4,096 bf16 operations a clock
// per SM), so overlapping the two is what the design is about. 288 threads
// at up to 224 registers fit the register file without setmaxnreg, so the
// roles need no rebalancing.
#include "attention_sm90.cuh"

namespace paa {
namespace sm90 {
namespace {

constexpr int kBQ = 128;     // query rows per block
constexpr int kBK = 128;     // keys per tile
constexpr int kStages = 4;
constexpr int kQBytes = kBQ * kRowBytes;
constexpr int kKVBytes = kBK * kRowBytes;

struct FwdSmem {
  bf16 q[kBQ * kD];
  bf16 k[kStages][kBK * kD];
  bf16 v[kStages][kBK * kD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kFwdSmem = sizeof(FwdSmem) + 1024;  // + alignment slack

// The online softmax of one score tile in registers: keys at or past T get
// −∞, the running max m (log2 units) and this thread's row sums l advance,
// alpha = 2^(m_old − m_new) is the rescale of the accumulator, and sc
// becomes p = 2^(s·log2 e − m).
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int k0, int T_len, int c0) {
  if (k0 + kBK > T_len) {  // the ragged last tile
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i / 4) + c0 + (i % 2) >= T_len) sc[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * kLog2e);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = exp2f(fmaf(sc[i], kLog2e, -m[r]));
    l[r] += sc[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                     float* __restrict__ lse, int T_len, int H) {
  extern __shared__ unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (T_len + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, kQBytes);
      tma_load_3d(sm.q, &map_q, h * kD, q0, b, &sm.q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kKVBytes);
        tma_load_3d(sm.k[s], &map_k, h * kD, j * kBK, b, &sm.full[s]);
        tma_load_3d(sm.v[s], &map_v, h * kD, j * kBK, b, &sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg …; this thread holds
  // rows r0 and r0 + 8 of them
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t q_desc = desc_sw128(sm.q + wg * 64 * kD);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, in log2 units
  float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum
  float alpha[2];
  float sc[64];
  uint32_t p[32];

  // Software pipeline over key tiles: S_j = Q·K_jᵀ and O += P_{j−1}·V_{j−1}
  // are issued together; the softmax of S_j runs while P_{j−1}·V_{j−1} is
  // still on the tensor cores. Stage j−1 is released once that product
  // is done, so the ring needs three stages or more.
  mbar_wait(&sm.q_full, 0);
  mbar_wait(&sm.full[0], 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss_n128(sc, q_desc + kstep_kmajor(kk), desc_sw128(sm.k[0]) + kstep_kmajor(kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(sc);
  online_softmax(sc, m, l, alpha, 0, T_len, c0);
  acc_to_a(sc, p);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int sp = (j - 1) % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    reg_fence(acc);
    reg_fence(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n128(sc, q_desc + kstep_kmajor(kk), desc_sw128(sm.k[s]) + kstep_kmajor(kk),
                    kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_n64_mn(acc, *reinterpret_cast<const uint32_t(*)[4]>(&p[4 * kk]),
                      desc_sw128(sm.v[sp]) + kstep_mnmajor(kk));
    wgmma_commit();
    wgmma_wait<1>();  // S_j is done, P_{j−1}·V_{j−1} may still run
    reg_fence(sc);
    online_softmax(sc, m, l, alpha, j * kBK, T_len, c0);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    mbar_arrive(&sm.empty[sp]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i / 2) % 2];
    acc_to_a(sc, p);
  }
  {
    const int sp = (n_tiles - 1) % kStages;
    reg_fence(acc);
    reg_fence(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_n64_mn(acc, *reinterpret_cast<const uint32_t(*)[4]>(&p[4 * kk]),
                      desc_sw128(sm.v[sp]) + kstep_mnmajor(kk));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    mbar_arrive(&sm.empty[sp]);
  }

  // o = acc / l, lse = (m + log2 l)·ln 2; rows past T are not stored
  const long row_stride = static_cast<long>(H) * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wg * 64 + r0 + 8 * r;
    if (row < T_len) {
      const float inv = 1.0f / l[r];
      bf16* orow = o + (static_cast<long>(b) * T_len + row) * row_stride + h * kD + c0;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16(acc[i] * inv, acc[i + 1] * inv);
      }
      if (lane % 4 == 0)
        lse[(static_cast<long>(b) * H + h) * T_len + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

}  // namespace
}  // namespace sm90
}  // namespace paa

// q, k, v, o: (B, T, H·64) contiguous bfloat16, 16-byte aligned; lse:
// (B, H, T) float32.
extern "C" int paa_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int T_len, int H, void* stream) {
  using namespace paa::sm90;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(attn_fwd_sm90_kernel, kFwdSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, q, B, T_len, H, kBQ) || !encode_map(&mk, k, B, T_len, H, kBK) ||
      !encode_map(&mv, v, B, T_len, H, kBK))
    return cudaErrorInvalidValue;
  dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  attn_fwd_sm90_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), T_len, H);
  return cudaGetLastError();
}
