// K2 — attention backward on Hopper, bf16 with head dim 64 (the base and
// lv60 paths). The float32 and head-dim-16 routes stay in attention_bwd.cu.
//
// Replaces paa_tpu/ops/pallas/attention.py:_bwd_kernel (launched by
// _attend_bwd), and the backward of the stock Pallas flash_attention
// (paa_tpu/models/wav2vec2.py:_flash_attention, T >= 774; K4). Same
// function as attention_bwd.cu: p = exp(s − lse), dp = do·vᵀ,
// ds = p·(dp − D) with D = rowsum(do ∘ o), dq = ds·k, dk = dsᵀ·q,
// dv = pᵀ·do; p and ds are rounded to bf16 before the three gradient
// products.
//
// What bounds it on the H100: five T×T×d products, 10·B·H·T²·d
// operations, so the tensor cores: 0.124 ms at base's shape (64, 499, 12,
// 64) and 0.331 ms at the lv60 microbatch (32, 999, 16, 64). The WMMA
// kernels it replaces staged every product through shared memory and ran
// their dk/dv kernel at 4 warps per SM.
//
// Design: three launches, deterministic, no float atomics (each block is
// the only writer of its rows; the same inputs give the same bits). s and
// dp are computed twice, once per gradient kernel: 7 products where the
// algorithm needs 5, the price of determinism.
//   1. prep (attention_sm90.cuh, shared with K8): D = rowsum(do ∘ o) and
//      lse·log2 e per (b, h, row), f32, into
//      scratch padded to a multiple of 128 rows; padded rows get D = 0 and
//      lse·log2 e = +∞, so their p is exactly 0 without a mask.
//   2. dkdv: a block owns 128 keys of one head (two consumer warpgroups of
//      64 keys) and loads its K and V once by TMA. The producer warp
//      streams Q, dO (TMA, 64 query rows a tile) and the tile's D and
//      lse·log2 e (bulk copies) through a 4-stage mbarrier ring. Per tile:
//      Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ on wgmma (shared operands, K-major), Pᵀ
//      and dSᵀ in registers, then dV += Pᵀ·dO and dK += dSᵀ·Q on wgmma with
//      Pᵀ and dSᵀ as register A operands and dO, Q MN-major. dK and dV stay
//      in registers. 9 warps per SM (the WMMA kernel had 4).
//   3. dq: the mirror. A block owns 128 query rows, loads Q and dO once and
//      streams K and V in tiles of 64 keys: S = Q·Kᵀ, dP = dO·Vᵀ, dS in
//      registers, dQ += dS·K with K MN-major; dQ stays in registers.
// In both gradient kernels the two consumer warpgroups take turns to issue
// their products (PingPong, attention_sm90.cuh), so that one's exp2 and ds
// run beside the other's wgmma. The loops are not software-pipelined as
// K1's is: a 288-thread block gets at most 168 registers a thread, and
// holding tile j−1's operands beside tile j's made dkdv spill and run
// slower on the H100. Both rings hold 4 stages; tools/attention_variants.py
// times 2 and 3, two dq blocks per SM, and the loops without the ping-pong.
#include "attention_sm90.cuh"

namespace paa {
namespace sm90 {
namespace {

constexpr int kStages = 4;

// ---- dk, dv ----------------------------------------------------------------

constexpr int kKVRows = 128;  // keys per block
constexpr int kQRows = 64;    // query rows per streamed tile

struct DkdvSmem {
  bf16 k[kKVRows * kD];
  bf16 v[kKVRows * kD];
  bf16 q[kStages][kQRows * kD];
  bf16 dout[kStages][kQRows * kD];
  float lse2[kStages][kQRows];
  float delta[kStages][kQRows];
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kDkdvSmem = sizeof(DkdvSmem) + 1024;
constexpr int kDkdvTileBytes = 2 * kQRows * kRowBytes + 2 * kQRows * 4;

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ delta, const float* __restrict__ lse2,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int H,
                          int Tpad) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int k0 = blockIdx.x * kKVRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (T_len + kQRows - 1) / kQRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * kKVRows * kRowBytes);
      tma_load_3d(sm.k, &map_k, h * kD, k0, b, &sm.kv_full);
      tma_load_3d(sm.v, &map_v, h * kD, k0, b, &sm.kv_full);
      const long stat = (static_cast<long>(b) * H + h) * Tpad;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], kDkdvTileBytes);
        tma_load_3d(sm.q[s], &map_q, h * kD, j * kQRows, b, &sm.full[s]);
        tma_load_3d(sm.dout[s], &map_do, h * kD, j * kQRows, b, &sm.full[s]);
        bulk_load(sm.lse2[s], lse2 + stat + j * kQRows, kQRows * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + stat + j * kQRows, kQRows * 4, &sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64·wg …; this thread holds rows
  // (keys) r0 and r0 + 8 of them, columns (queries) c0 + 8·n + {0, 1}
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t dk_desc = desc_sw128(sm.k + wg * 64 * kD);
  const uint64_t dv_desc = desc_sw128(sm.v + wg * 64 * kD);

  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  const PingPong pp{wg};
  pp.start();
  mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    const uint64_t dq_desc = desc_sw128(sm.q[s]);
    const uint64_t ddo_desc = desc_sw128(sm.dout[s]);

    float st[32], dpt[32];  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(st, dk_desc + kstep_kmajor(kk), dq_desc + kstep_kmajor(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(dpt, dv_desc + kstep_kmajor(kk), ddo_desc + kstep_kmajor(kk), kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + c0 + (i % 2);
      const float p = exp2f(fmaf(st[i], kLog2e, -sm.lse2[s][c]));
      dpt[i] = p * (dpt[i] - sm.delta[s][c]);
      st[i] = p;
    }
    uint32_t pa[16], dsa[16];
    acc_to_a(st, pa);
    acc_to_a(dpt, dsa);
    reg_fence(pa);  // the packing is done before the fence
    reg_fence(dsa);
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk)
      wgmma_rs_n64_mn(acc_dv, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]),
                      ddo_desc + kstep_mnmajor(kk));
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk)
      wgmma_rs_n64_mn(acc_dk, *reinterpret_cast<const uint32_t(*)[4]>(&dsa[4 * kk]),
                      dq_desc + kstep_mnmajor(kk));
    wgmma_commit();
    pp.pass(j == n_tiles - 1);
    wgmma_wait_all();
    reg_fence(acc_dv);
    reg_fence(acc_dk);
    reg_fence(pa);
    reg_fence(dsa);
    mbar_arrive(&sm.empty[s]);
  }

  const long row_stride = static_cast<long>(H) * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + wg * 64 + r0 + 8 * r;
    if (row >= T_len) continue;
    const long off = (static_cast<long>(b) * T_len + row) * row_stride + h * kD + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack_bf16(acc_dk[i], acc_dk[i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) = pack_bf16(acc_dv[i], acc_dv[i + 1]);
    }
  }
}

// ---- dq ------------------------------------------------------------------

constexpr int kQBlock = 128;  // query rows per block
constexpr int kKTile = 64;    // keys per streamed tile

struct DqSmem {
  bf16 q[kQBlock * kD];
  bf16 dout[kQBlock * kD];
  bf16 k[kStages][kKTile * kD];
  bf16 v[kStages][kKTile * kD];
  uint64_t q_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kDqSmem = sizeof(DqSmem) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ delta, const float* __restrict__ lse2,
                        bf16* __restrict__ dq, int T_len, int H, int Tpad) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int q0 = blockIdx.x * kQBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (T_len + kKTile - 1) / kKTile;
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
      mbar_expect_tx(&sm.q_full, 2 * kQBlock * kRowBytes);
      tma_load_3d(sm.q, &map_q, h * kD, q0, b, &sm.q_full);
      tma_load_3d(sm.dout, &map_do, h * kD, q0, b, &sm.q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * kKTile * kRowBytes);
        tma_load_3d(sm.k[s], &map_k, h * kD, j * kKTile, b, &sm.full[s]);
        tma_load_3d(sm.v[s], &map_v, h * kD, j * kKTile, b, &sm.full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg …; this thread holds
  // rows r0 and r0 + 8 of them, columns (keys) c0 + 8·n + {0, 1}
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t q_desc = desc_sw128(sm.q + wg * 64 * kD);
  const uint64_t do_desc = desc_sw128(sm.dout + wg * 64 * kD);
  const long stat = (static_cast<long>(b) * H + h) * Tpad + q0 + wg * 64 + r0;
  const float row_lse2[2] = {lse2[stat], lse2[stat + 8]};
  const float row_delta[2] = {delta[stat], delta[stat + 8]};

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  const PingPong pp{wg};
  pp.start();
  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    const uint64_t k_desc = desc_sw128(sm.k[s]);
    const uint64_t v_desc = desc_sw128(sm.v[s]);

    float sc[32], dp[32];  // S = Q·Kᵀ, dP = dO·Vᵀ
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(sc, q_desc + kstep_kmajor(kk), k_desc + kstep_kmajor(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(dp, do_desc + kstep_kmajor(kk), v_desc + kstep_kmajor(kk), kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);

    const int k0 = j * kKTile;
    const bool ragged = k0 + kKTile > T_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float p = exp2f(fmaf(sc[i], kLog2e, -row_lse2[r]));
      if (ragged && k0 + 8 * (i / 4) + c0 + (i % 2) >= T_len) p = 0.0f;
      dp[i] = p * (dp[i] - row_delta[r]);
    }
    uint32_t dsa[16];
    acc_to_a(dp, dsa);
    reg_fence(dsa);  // the packing is done before the fence
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk)
      wgmma_rs_n64_mn(acc, *reinterpret_cast<const uint32_t(*)[4]>(&dsa[4 * kk]),
                      k_desc + kstep_mnmajor(kk));
    wgmma_commit();
    pp.pass(j == n_tiles - 1);
    wgmma_wait_all();
    reg_fence(acc);
    reg_fence(dsa);
    mbar_arrive(&sm.empty[s]);
  }

  const long row_stride = static_cast<long>(H) * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + r0 + 8 * r;
    if (row >= T_len) continue;
    bf16* out = dq + (static_cast<long>(b) * T_len + row) * row_stride + h * kD + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(out + 8 * n) = pack_bf16(acc[i], acc[i + 1]);
    }
  }
}

}  // namespace
}  // namespace sm90
}  // namespace paa

// Tpad, the rows per (b, h) of the backward's scratch: T rounded up to a
// multiple of 128.
extern "C" int paa_attention_bwd_sm90_rows(int T_len) {
  using namespace paa::sm90;
  return (T_len + kRowPad - 1) / kRowPad * kRowPad;
}

// q, k, v, o, do, dq, dk, dv: (B, T, H·64) contiguous bfloat16, 16-byte
// aligned; lse: (B, H, T) float32 from the forward; scratch: float32
// (2, B, H, Tpad), Tpad from paa_attention_bwd_sm90_rows.
extern "C" int paa_attention_bwd_sm90(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dq, void* dk,
                                      void* dv, void* scratch, int B, int T_len, int H,
                                      void* stream) {
  using namespace paa::sm90;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(attn_bwd_dkdv_sm90_kernel, kDkdvSmem);
    if (err == cudaSuccess) err = allow_smem(attn_bwd_dq_sm90_kernel, kDqSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int Tpad = paa_attention_bwd_sm90_rows(T_len);
  float* delta = static_cast<float*>(scratch);
  float* lse2 = delta + static_cast<long>(B) * H * Tpad;

  cudaError_t err = launch_bwd_prep(o, dout, lse, delta, lse2, B, T_len, H, Tpad, st);
  if (err != cudaSuccess) return err;

  // dkdv streams query tiles of 64 rows and holds 128 keys; dq holds 128
  // query rows and streams key tiles of 64
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!encode_map(&q64, q, B, T_len, H, kQRows) || !encode_map(&do64, dout, B, T_len, H, kQRows) ||
      !encode_map(&k128, k, B, T_len, H, kKVRows) || !encode_map(&v128, v, B, T_len, H, kKVRows) ||
      !encode_map(&q128, q, B, T_len, H, kQBlock) ||
      !encode_map(&do128, dout, B, T_len, H, kQBlock) ||
      !encode_map(&k64, k, B, T_len, H, kKTile) || !encode_map(&v64, v, B, T_len, H, kKTile))
    return cudaErrorInvalidValue;

  dim3 grid_kv((T_len + kKVRows - 1) / kKVRows, H, B);
  attn_bwd_dkdv_sm90_kernel<<<grid_kv, kThreads, kDkdvSmem, st>>>(
      q64, k128, v128, do64, delta, lse2, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_len,
      H, Tpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((T_len + kQBlock - 1) / kQBlock, H, B);
  attn_bwd_dq_sm90_kernel<<<grid_q, kThreads, kDqSmem, st>>>(
      q128, k64, v64, do128, delta, lse2, static_cast<bf16*>(dq), T_len, H, Tpad);
  return cudaGetLastError();
}
