// K8 — relative-position attention on Hopper, bf16 with head dim 64: the
// attention of the Wav2Vec2-Conformer with Transformer-XL positions
// (arXiv 1901.02860 §3.3; transformers' Wav2Vec2ConformerSelfAttention with
// position_embeddings_type "relative"). Per head, with the biased queries
// qu = (q + u)·c and qv = (q + v)·c made by the model (c = d^−½):
//
//   s[i, j] = qu[i]·k[j] + qv[i]·P[T − 1 − i + j],   o = softmax(s)·v
//
// where P (2T − 1, H·64) is the layer's projected sinusoid table, row r at
// relative position T − 1 − r, shared by the batch. The second term is
// Transformer-XL's rel_shift of qv·Pᵀ.
//
// Replaces no TPU kernel: the JAX package has no relative-position model.
// It was added because neither K1/K2 route can add a score term that
// depends on i − j, and computing that term eagerly writes (B, H, T, 2T − 1)
// scores to device memory: 2.3 GB a layer each way at a 30 s microbatch of
// 16. Here neither (B, H, T, T) nor (B, H, T, 2T − 1) leaves the chip.
//
// What bounds it on the H100: the forward's three T×T×d products
// (6·B·H·T²·d operations) and the backward's seven (14·B·H·T²·d: the
// scores and the positional term again, dP, dq's two, dk, dv), so the
// tensor cores, as K1/K2.
//
// The positional term of a tile. For 64 query rows i0 + ii and a tile of
// keys j0 + jj, the rows of P that the tile needs form a band of 63 + BK
// rows starting at T − 64 − i0 + j0: band row cb = 63 − ii + jj. So the
// tile's term is a product G = qv·bandᵀ (64 × (63 + BK), one wgmma) whose
// element (ii, cb) belongs to score (ii, cb − 63 + ii): each warpgroup
// writes G skewed into a float32 tile in shared memory and adds it to its
// score fragment from there. The backward's dq takes the same skew the
// other way: dS is written skewed into a bf16 operand tile, zero off the
// band, and dq_v = skew(dS)·band is one more wgmma. P is streamed in chunks
// of rows that successive tiles share (TMA, zero fill outside 0 … 2T − 2;
// the coordinates may be negative), each chunk serving the two or three
// tiles whose bands cover it.
//
// Three kernels on the building blocks of K1/K2 (attention_sm90.cuh), each
// a block of 288 threads: one producer warp feeding mbarrier rings by TMA
// and two consumer warpgroups of 64 rows, which take turns to issue their
// products (PingPong) so that one's skew and softmax run beside the other's
// wgmma. A warpgroup's products run one after another: issuing S while G's
// skew runs (as K1 pipelines its loop) needs more than the 168 registers a
// thread has here, and the spills made the forward 22 % slower on the H100.
// Deterministic (no atomics): each block is the only writer of its rows.
//   fwd:  a block owns 128 query rows; key tiles of 128, P in chunks of 128.
//   bwd:  K2's prep (D, lse·log2 e); dkdv, a block owning 128 keys and
//         streaming query tiles of 64 with P in chunks of 64; dq, a block
//         owning 128 query rows and streaming key tiles of 64, writing
//         dq_u = dS·K and dq_v = skew(dS)·P. The model adds the two, and
//         autograd takes them through (q + u)·c and (q + v)·c.
#include "attention_sm90.cuh"

namespace paa {
namespace sm90 {
namespace {

// A warpgroup's own barrier (named barriers 3 and 4; 1 and 2 are PingPong's).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// Shared memory written by this thread's plain stores becomes visible to
// the async proxy (the wgmma that reads it after a barrier).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D[64][64] += A[64][16]·B[16][64]; A K-major and B MN-major (the transpose
// bit), both in shared memory.
__device__ __forceinline__ void wgmma_ss_n64_bmn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Write the accumulator `acc` of a 64-row product whose columns are band
// rows off … off + N/2·… (the thread's rows r0, r0 + 8 and columns c0 + 8·n
// + {0, 1}, as attention_sm90.cuh lays them out) into the score tile `g`
// (64 × stride floats) at column band − 63 + row, where that lies in
// [0, cols). Each score of the tile receives exactly one value.
template <int N>
__device__ __forceinline__ void skew_rows(const float (&acc)[N], float* g, int stride, int cols,
                                          int off, int r0, int c0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int jj = off + 8 * (i / 4) + c0 + (i % 2) - 63 + row;
    if (jj >= 0 && jj < cols) g[row * stride + jj] = acc[i];
  }
}

// The same, for an accumulator whose rows are band rows off + … and whose
// columns are query rows ii: the value (band, ii) goes to row band − 63 + ii
// of the key-major tile `g`, column ii.
__device__ __forceinline__ void skew_cols(const float (&acc)[32], float* g, int stride, int off,
                                          int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ii = 8 * (i / 4) + c0 + (i % 2);
    const int jj = off + r0 + 8 * ((i / 2) % 2) - 63 + ii;
    if (jj >= 0 && jj < 64) g[jj * stride + ii] = acc[i];
  }
}

// sc[i] += g at the fragment position of sc[i] (rows r0, r0 + 8; columns
// c0 + 8·n + {0, 1}), N/2 columns.
template <int N>
__device__ __forceinline__ void add_tile(float (&sc)[N], const float* g, int stride, int r0,
                                         int c0) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const float2 t = *reinterpret_cast<const float2*>(g + row * stride + 8 * (i / 4) + c0);
    sc[i] += t.x;
    sc[i + 1] += t.y;
  }
}

// ---- forward ----------------------------------------------------------------

constexpr int kBQ = 128;     // query rows per block
constexpr int kBK = 128;     // keys per tile
constexpr int kKVStages = 2;
constexpr int kFwdChunk = 128;  // rows of P per chunk: tile j's band is chunks j and j + 1
constexpr int kFwdRing = 3;
constexpr int kFwdG = kBK + 8;  // row stride of the skewed score tile (floats)

struct FwdSmem {
  bf16 qu[kBQ * kD];
  bf16 qv[kBQ * kD];
  bf16 k[kKVStages][kBK * kD];
  bf16 v[kKVStages][kBK * kD];
  bf16 pos[kFwdRing][kFwdChunk * kD];
  float g[2][64 * kFwdG];
  uint64_t q_full;
  uint64_t kv_full[kKVStages];
  uint64_t kv_empty[kKVStages];
  uint64_t pos_full[kFwdRing];
  uint64_t pos_empty[kFwdRing];
};
constexpr int kFwdSmem = sizeof(FwdSmem) + 1024;

// K1's online softmax of one score tile in registers (attention_fwd_sm90.cu).
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
relpos_fwd_kernel(const __grid_constant__ CUtensorMap map_qu,
                  const __grid_constant__ CUtensorMap map_qv,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_p, bf16* __restrict__ o,
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
    for (int s = 0; s < kKVStages; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.kv_empty[s], kConsumers);
    }
    for (int s = 0; s < kFwdRing; ++s) {
      mbar_init(&sm.pos_full[s], 1);
      mbar_init(&sm.pos_empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, 2 * kBQ * kRowBytes);
      tma_load_3d(sm.qu, &map_qu, h * kD, q0, b, &sm.q_full);
      tma_load_3d(sm.qv, &map_qv, h * kD, q0, b, &sm.q_full);
      // chunk m: rows T − 128 − q0 + 128·m …; tile j's band is chunks j, j + 1
      auto load_chunk = [&](int m) {
        const int s = m % kFwdRing;
        mbar_wait(&sm.pos_empty[s], ((m / kFwdRing) & 1) ^ 1);
        mbar_expect_tx(&sm.pos_full[s], kFwdChunk * kRowBytes);
        tma_load_3d(sm.pos[s], &map_p, h * kD, T_len - kBQ - q0 + kFwdChunk * m, 0,
                    &sm.pos_full[s]);
      };
      load_chunk(0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kKVStages;
        mbar_wait(&sm.kv_empty[s], ((j / kKVStages) & 1) ^ 1);
        mbar_expect_tx(&sm.kv_full[s], 2 * kBK * kRowBytes);
        tma_load_3d(sm.k[s], &map_k, h * kD, j * kBK, b, &sm.kv_full[s]);
        tma_load_3d(sm.v[s], &map_v, h * kD, j * kBK, b, &sm.kv_full[s]);
        load_chunk(j + 1);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg …; this thread holds
  // rows r0 and r0 + 8 of them. Its band is rows 64·(1 − wg) … of the
  // block's band (chunks j, j + 1): warpgroup 1 takes chunk j whole (band
  // columns 0 … 127) and the first half of chunk j + 1 (128 … 191),
  // warpgroup 0 the second half of chunk j (0 … 63) and chunk j + 1 whole
  // (64 … 191).
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t qu_desc = desc_sw128(sm.qu + wg * 64 * kD);
  const uint64_t qv_desc = desc_sw128(sm.qv + wg * 64 * kD);
  float* g = sm.g[wg];
  const int off128 = wg ? 0 : 64;
  const int off64 = wg ? 128 : 0;

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, in log2 units
  float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum
  float alpha[2];
  uint32_t p[32];

  const PingPong pp{wg};
  pp.start();
  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kKVStages;
    const int ca = j % kFwdRing;
    const int cb = (j + 1) % kFwdRing;
    mbar_wait(&sm.kv_full[s], (j / kKVStages) & 1);
    mbar_wait(&sm.pos_full[ca], (j / kFwdRing) & 1);
    mbar_wait(&sm.pos_full[cb], ((j + 1) / kFwdRing) & 1);
    const bf16* band128 = wg ? sm.pos[ca] : sm.pos[cb];
    const bf16* band64 = wg ? sm.pos[cb] : sm.pos[ca] + 64 * kD;

    // G = Qv·bandᵀ, skewed into the score tile; then S = Qu·Kᵀ, and the
    // tile added to it. Three turns of the ping-pong a tile: G, S, P·V
    float g128[64], g64[32], sc[64];
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n128(g128, qv_desc + kstep_kmajor(kk), desc_sw128(band128) + kstep_kmajor(kk),
                    kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(g64, qv_desc + kstep_kmajor(kk), desc_sw128(band64) + kstep_kmajor(kk),
                   kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait<0>();
    reg_fence(g128);
    reg_fence(g64);
    skew_rows(g128, g, kFwdG, kBK, off128, r0, c0);
    skew_rows(g64, g, kFwdG, kBK, off64, r0, c0);
    wg_sync(wg);
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n128(sc, qu_desc + kstep_kmajor(kk), desc_sw128(sm.k[s]) + kstep_kmajor(kk),
                    kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait<0>();
    reg_fence(sc);
    add_tile(sc, g, kFwdG, r0, c0);
    wg_sync(wg);  // the tile is read before the next tile's skew writes it

    online_softmax(sc, m, l, alpha, j * kBK, T_len, c0);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i / 2) % 2];
    acc_to_a(sc, p);
    reg_fence(acc);
    reg_fence(p);
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_n64_mn(acc, *reinterpret_cast<const uint32_t(*)[4]>(&p[4 * kk]),
                      desc_sw128(sm.v[s]) + kstep_mnmajor(kk));
    wgmma_commit();
    pp.pass(j == n_tiles - 1);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    mbar_arrive(&sm.kv_empty[s]);
    mbar_arrive(&sm.pos_empty[ca]);  // chunk j serves no later tile
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

// ---- backward -----------------------------------------------------------------

constexpr int kBStages = 3;   // ring of the streamed tiles
constexpr int kBChunk = 64;   // rows of P per chunk: a tile's band is three chunks
constexpr int kBRing = 4;
constexpr int kBG = 64 + 8;   // row stride of the skewed 64 × 64 score tile (floats)

// ---- dk, dv: a block owns 128 keys, streams query tiles of 64 ----------------

struct DkdvSmem {
  bf16 k[128 * kD];
  bf16 v[128 * kD];
  bf16 qu[kBStages][64 * kD];
  bf16 qv[kBStages][64 * kD];
  bf16 dout[kBStages][64 * kD];
  bf16 pos[kBRing][kBChunk * kD];
  float g[2][64 * kBG];
  float lse2[kBStages][64];
  float delta[kBStages][64];
  uint64_t kv_full;
  uint64_t full[kBStages];
  uint64_t empty[kBStages];
  uint64_t pos_full[kBRing];
  uint64_t pos_empty[kBRing];
};
constexpr int kDkdvSmem = sizeof(DkdvSmem) + 1024;
constexpr int kDkdvTileBytes = 3 * 64 * kRowBytes + 2 * 64 * 4;

__global__ void __launch_bounds__(kThreads, 1)
relpos_dkdv_kernel(const __grid_constant__ CUtensorMap map_qu,
                   const __grid_constant__ CUtensorMap map_qv,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __grid_constant__ CUtensorMap map_p, const float* __restrict__ delta,
                   const float* __restrict__ lse2, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int T_len, int H, int Tpad) {
  extern __shared__ unsigned char smem_raw[];
  DkdvSmem& sm = *reinterpret_cast<DkdvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int k0 = blockIdx.x * 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (T_len + 63) / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    for (int s = 0; s < kBRing; ++s) {
      mbar_init(&sm.pos_full[s], 1);
      mbar_init(&sm.pos_empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.kv_full, 2 * 128 * kRowBytes);
      tma_load_3d(sm.k, &map_k, h * kD, k0, b, &sm.kv_full);
      tma_load_3d(sm.v, &map_v, h * kD, k0, b, &sm.kv_full);
      // chunk u: rows T + 64 + k0 − 64·u …; query tile t's band is chunks
      // t + 2, t + 1, t from its first row on
      auto load_chunk = [&](int u) {
        const int s = u % kBRing;
        mbar_wait(&sm.pos_empty[s], ((u / kBRing) & 1) ^ 1);
        mbar_expect_tx(&sm.pos_full[s], kBChunk * kRowBytes);
        tma_load_3d(sm.pos[s], &map_p, h * kD, T_len + 64 + k0 - kBChunk * u, 0,
                    &sm.pos_full[s]);
      };
      load_chunk(0);
      load_chunk(1);
      const long stat = (static_cast<long>(b) * H + h) * Tpad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kBStages;
        mbar_wait(&sm.empty[s], ((t / kBStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], kDkdvTileBytes);
        tma_load_3d(sm.qu[s], &map_qu, h * kD, t * 64, b, &sm.full[s]);
        tma_load_3d(sm.qv[s], &map_qv, h * kD, t * 64, b, &sm.full[s]);
        tma_load_3d(sm.dout[s], &map_do, h * kD, t * 64, b, &sm.full[s]);
        bulk_load(sm.lse2[s], lse2 + stat + t * 64, 64 * 4, &sm.full[s]);
        bulk_load(sm.delta[s], delta + stat + t * 64, 64 * 4, &sm.full[s]);
        load_chunk(t + 2);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64·wg …; this thread holds rows
  // (keys) r0 and r0 + 8 of them, columns (queries) c0 + 8·n + {0, 1}. Its
  // band is 128 rows: warpgroup 0 chunks t + 2 (band rows 0 … 63) and t + 1
  // (64 … 127), warpgroup 1 chunks t + 1 and t.
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t k_desc = desc_sw128(sm.k + wg * 64 * kD);
  const uint64_t v_desc = desc_sw128(sm.v + wg * 64 * kD);
  float* g = sm.g[wg];

  float acc_dk[32], acc_dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  const PingPong pp{wg};
  pp.start();
  mbar_wait(&sm.kv_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kBStages;
    mbar_wait(&sm.full[s], (t / kBStages) & 1);
    for (int u = t; u < t + 3; ++u) mbar_wait(&sm.pos_full[u % kBRing], (u / kBRing) & 1);
    const bf16* band_lo = sm.pos[(t + 2 - wg) % kBRing];
    const bf16* band_hi = sm.pos[(t + 1 - wg) % kBRing];
    const uint64_t qu_desc = desc_sw128(sm.qu[s]);
    const uint64_t qv_desc = desc_sw128(sm.qv[s]);
    const uint64_t do_desc = desc_sw128(sm.dout[s]);

    // Y = band·Qvᵀ (128 band rows × 64 queries), skewed into the key-major
    // tile: Sᵀ's positional term
    {
      float y_lo[32], y_hi[32];
      pp.wait_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(y_lo, desc_sw128(band_lo) + kstep_kmajor(kk), qv_desc + kstep_kmajor(kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(y_hi, desc_sw128(band_hi) + kstep_kmajor(kk), qv_desc + kstep_kmajor(kk),
                     kk > 0);
      wgmma_commit();
      pp.pass(false);
      wgmma_wait_all();
      reg_fence(y_lo);
      reg_fence(y_hi);
      skew_cols(y_lo, g, kBG, 0, r0, c0);
      skew_cols(y_hi, g, kBG, 64, r0, c0);
      wg_sync(wg);
    }

    float st[32], dpt[32];  // Sᵀ = K·Quᵀ + the term, dPᵀ = V·dOᵀ
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(st, k_desc + kstep_kmajor(kk), qu_desc + kstep_kmajor(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(dpt, v_desc + kstep_kmajor(kk), do_desc + kstep_kmajor(kk), kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait_all();
    reg_fence(st);
    reg_fence(dpt);
    add_tile(st, g, kBG, r0, c0);
    wg_sync(wg);  // the tile is read before the next tile's skew writes it

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + c0 + (i % 2);
      const float pr = exp2f(fmaf(st[i], kLog2e, -sm.lse2[s][c]));
      dpt[i] = pr * (dpt[i] - sm.delta[s][c]);
      st[i] = pr;
    }
    uint32_t pa[16], dsa[16];
    acc_to_a(st, pa);
    acc_to_a(dpt, dsa);
    reg_fence(pa);
    reg_fence(dsa);
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs_n64_mn(acc_dv, *reinterpret_cast<const uint32_t(*)[4]>(&pa[4 * kk]),
                      do_desc + kstep_mnmajor(kk));
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs_n64_mn(acc_dk, *reinterpret_cast<const uint32_t(*)[4]>(&dsa[4 * kk]),
                      qu_desc + kstep_mnmajor(kk));
    wgmma_commit();
    pp.pass(t == n_tiles - 1);
    wgmma_wait_all();
    reg_fence(acc_dv);
    reg_fence(acc_dk);
    reg_fence(pa);
    reg_fence(dsa);
    mbar_arrive(&sm.empty[s]);
    mbar_arrive(&sm.pos_empty[t % kBRing]);  // chunk t serves no later tile
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

// ---- dq_u, dq_v: a block owns 128 query rows, streams key tiles of 64 --------

struct DqSmem {
  bf16 qu[128 * kD];
  bf16 qv[128 * kD];
  bf16 dout[128 * kD];
  bf16 k[kBStages][64 * kD];
  bf16 v[kBStages][64 * kD];
  bf16 pos[kBRing][kBChunk * kD];
  bf16 ds[2][2][64 * kD];  // per warpgroup: skew(dS), band columns 0 … 63 and 64 … 127
  float g[2][64 * kBG];
  uint64_t q_full;
  uint64_t full[kBStages];
  uint64_t empty[kBStages];
  uint64_t pos_full[kBRing];
  uint64_t pos_empty[kBRing];
};
constexpr int kDqSmem = sizeof(DqSmem) + 1024;

// Element (row, col) of a 64 × 64 bf16 tile in the 128-byte swizzle.
__device__ __forceinline__ bf16* swizzled(bf16* tile, int row, int col) {
  return tile + row * kD + ((((col / 8) ^ (row % 8)) * 8) | (col % 8));
}

__global__ void __launch_bounds__(kThreads, 1)
relpos_dq_kernel(const __grid_constant__ CUtensorMap map_qu,
                 const __grid_constant__ CUtensorMap map_qv,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __grid_constant__ CUtensorMap map_p, const float* __restrict__ delta,
                 const float* __restrict__ lse2, bf16* __restrict__ dqu, bf16* __restrict__ dqv,
                 int T_len, int H, int Tpad) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (T_len + 63) / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers);
    }
    for (int s = 0; s < kBRing; ++s) {
      mbar_init(&sm.pos_full[s], 1);
      mbar_init(&sm.pos_empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&sm.q_full, 3 * 128 * kRowBytes);
      tma_load_3d(sm.qu, &map_qu, h * kD, q0, b, &sm.q_full);
      tma_load_3d(sm.qv, &map_qv, h * kD, q0, b, &sm.q_full);
      tma_load_3d(sm.dout, &map_do, h * kD, q0, b, &sm.q_full);
      // chunk m: rows T − 128 − q0 + 64·m …; key tile j's band is chunks
      // j, j + 1, j + 2
      auto load_chunk = [&](int m) {
        const int s = m % kBRing;
        mbar_wait(&sm.pos_empty[s], ((m / kBRing) & 1) ^ 1);
        mbar_expect_tx(&sm.pos_full[s], kBChunk * kRowBytes);
        tma_load_3d(sm.pos[s], &map_p, h * kD, T_len - 128 - q0 + kBChunk * m, 0,
                    &sm.pos_full[s]);
      };
      load_chunk(0);
      load_chunk(1);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kBStages;
        mbar_wait(&sm.empty[s], ((j / kBStages) & 1) ^ 1);
        mbar_expect_tx(&sm.full[s], 2 * 64 * kRowBytes);
        tma_load_3d(sm.k[s], &map_k, h * kD, j * 64, b, &sm.full[s]);
        tma_load_3d(sm.v[s], &map_v, h * kD, j * 64, b, &sm.full[s]);
        load_chunk(j + 2);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64·wg …; this thread holds
  // rows r0 and r0 + 8 of them, columns (keys) c0 + 8·n + {0, 1}. Its band
  // is 128 rows: warpgroup 1 chunks j (band rows 0 … 63) and j + 1
  // (64 … 127), warpgroup 0 chunks j + 1 and j + 2.
  const int wg = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint64_t qu_desc = desc_sw128(sm.qu + wg * 64 * kD);
  const uint64_t qv_desc = desc_sw128(sm.qv + wg * 64 * kD);
  const uint64_t do_desc = desc_sw128(sm.dout + wg * 64 * kD);
  float* g = sm.g[wg];
  bf16* ds_lo = sm.ds[wg][0];
  bf16* ds_hi = sm.ds[wg][1];
  const long stat = (static_cast<long>(b) * H + h) * Tpad + q0 + wg * 64 + r0;
  const float row_lse2[2] = {lse2[stat], lse2[stat + 8]};
  const float row_delta[2] = {delta[stat], delta[stat + 8]};

  float acc_u[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_u[i] = acc_v[i] = 0.0f;

  {  // skew(dS) is 0 off the band at the same places in every tile: zero it once
    uint4* z = reinterpret_cast<uint4*>(sm.ds[wg]);
    for (int i = threadIdx.x % 128; i < 2 * 64 * kD / 8; i += 128) z[i] = make_uint4(0, 0, 0, 0);
  }
  const PingPong pp{wg};
  pp.start();
  mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kBStages;
    mbar_wait(&sm.full[s], (j / kBStages) & 1);
    for (int m = j; m < j + 3; ++m) mbar_wait(&sm.pos_full[m % kBRing], (m / kBRing) & 1);
    const bf16* band_lo = sm.pos[(j + 1 - wg) % kBRing];
    const bf16* band_hi = sm.pos[(j + 2 - wg) % kBRing];
    const uint64_t k_desc = desc_sw128(sm.k[s]);
    const uint64_t v_desc = desc_sw128(sm.v[s]);

    // G = Qv·bandᵀ (64 queries × 128 band rows), skewed into the score tile
    {
      float g_lo[32], g_hi[32];
      pp.wait_turn();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(g_lo, qv_desc + kstep_kmajor(kk), desc_sw128(band_lo) + kstep_kmajor(kk),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_ss_n64(g_hi, qv_desc + kstep_kmajor(kk), desc_sw128(band_hi) + kstep_kmajor(kk),
                     kk > 0);
      wgmma_commit();
      pp.pass(false);
      wgmma_wait_all();
      reg_fence(g_lo);
      reg_fence(g_hi);
      skew_rows(g_lo, g, kBG, 64, 0, r0, c0);
      skew_rows(g_hi, g, kBG, 64, 64, r0, c0);
      wg_sync(wg);
    }

    float sc[32], dp[32];  // S = Qu·Kᵀ + the term, dP = dO·Vᵀ
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(sc, qu_desc + kstep_kmajor(kk), k_desc + kstep_kmajor(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64(dp, do_desc + kstep_kmajor(kk), v_desc + kstep_kmajor(kk), kk > 0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait_all();
    reg_fence(sc);
    reg_fence(dp);
    add_tile(sc, g, kBG, r0, c0);

    const int k0 = j * 64;
    const bool ragged = k0 + 64 > T_len;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i / 2) % 2;
      float pr = exp2f(fmaf(sc[i], kLog2e, -row_lse2[r]));
      if (ragged && k0 + 8 * (i / 4) + c0 + (i % 2) >= T_len) pr = 0.0f;
      dp[i] = pr * (dp[i] - row_delta[r]);
    }
    uint32_t dsa[16];
    acc_to_a(dp, dsa);
    // skew(dS) in bf16: dS[row][jj] at band column jj + 63 − row
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = r0 + 8 * ((i / 2) % 2);
      const int cb = 8 * (i / 4) + c0 + (i % 2) + 63 - row;
      const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&dsa[i / 2]);
      *swizzled(cb < 64 ? ds_lo : ds_hi, row, cb % 64) = (i % 2) ? pair.y : pair.x;
    }
    fence_async_smem();
    wg_sync(wg);  // skew(dS) is whole, and the score tile is read
    reg_fence(dsa);
    pp.wait_turn();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 64 / 16; ++kk)
      wgmma_rs_n64_mn(acc_u, *reinterpret_cast<const uint32_t(*)[4]>(&dsa[4 * kk]),
                      k_desc + kstep_mnmajor(kk));
#pragma unroll
    for (int kk = 0; kk < 128 / 16; ++kk)
      wgmma_ss_n64_bmn(acc_v, desc_sw128(kk < 4 ? ds_lo : ds_hi) + kstep_kmajor(kk % 4),
                       desc_sw128(kk < 4 ? band_lo : band_hi) + kstep_mnmajor(kk % 4));
    wgmma_commit();
    pp.pass(j == n_tiles - 1);
    wgmma_wait_all();
    reg_fence(acc_u);
    reg_fence(acc_v);
    reg_fence(dsa);
    mbar_arrive(&sm.empty[s]);
    mbar_arrive(&sm.pos_empty[j % kBRing]);  // chunk j serves no later tile
  }

  const long row_stride = static_cast<long>(H) * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + r0 + 8 * r;
    if (row >= T_len) continue;
    const long off = (static_cast<long>(b) * T_len + row) * row_stride + h * kD + c0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<uint32_t*>(dqu + off + 8 * n) = pack_bf16(acc_u[i], acc_u[i + 1]);
      *reinterpret_cast<uint32_t*>(dqv + off + 8 * n) = pack_bf16(acc_v[i], acc_v[i + 1]);
    }
  }
}

}  // namespace
}  // namespace sm90
}  // namespace paa

// qu, qv, k, v, o: (B, T, H·64) contiguous bfloat16, 16-byte aligned; pos:
// (2T − 1, H·64) contiguous bfloat16; lse: (B, H, T) float32.
extern "C" int paa_attention_relpos_fwd_sm90(const void* qu, const void* qv, const void* k,
                                             const void* v, const void* pos, void* o, void* lse,
                                             int B, int T_len, int H, void* stream) {
  using namespace paa::sm90;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(relpos_fwd_kernel, kFwdSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mqu, mqv, mk, mv, mp;
  if (!encode_map(&mqu, qu, B, T_len, H, kBQ) || !encode_map(&mqv, qv, B, T_len, H, kBQ) ||
      !encode_map(&mk, k, B, T_len, H, kBK) || !encode_map(&mv, v, B, T_len, H, kBK) ||
      !encode_map(&mp, pos, 1, 2 * T_len - 1, H, kFwdChunk))
    return cudaErrorInvalidValue;
  dim3 grid((T_len + kBQ - 1) / kBQ, H, B);
  relpos_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      mqu, mqv, mk, mv, mp, static_cast<bf16*>(o), static_cast<float*>(lse), T_len, H);
  return cudaGetLastError();
}

// qu, qv, k, v, o, do, dqu, dqv, dk, dv: (B, T, H·64) contiguous bfloat16,
// 16-byte aligned; pos: (2T − 1, H·64) bfloat16; lse: (B, H, T) float32
// from the forward; scratch: float32 (2, B, H, Tpad), Tpad from
// paa_attention_bwd_sm90_rows.
extern "C" int paa_attention_relpos_bwd_sm90(const void* qu, const void* qv, const void* k,
                                             const void* v, const void* pos, const void* o,
                                             const void* lse, const void* dout, void* dqu,
                                             void* dqv, void* dk, void* dv, void* scratch, int B,
                                             int T_len, int H, void* stream) {
  using namespace paa::sm90;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(relpos_dkdv_kernel, kDkdvSmem);
    if (err == cudaSuccess) err = allow_smem(relpos_dq_kernel, kDqSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int Tpad = (T_len + kRowPad - 1) / kRowPad * kRowPad;
  float* delta = static_cast<float*>(scratch);
  float* lse2 = delta + static_cast<long>(B) * H * Tpad;
  cudaError_t err = launch_bwd_prep(o, dout, lse, delta, lse2, B, T_len, H, Tpad, st);
  if (err != cudaSuccess) return err;

  CUtensorMap qu64, qv64, do64, k128, v128, qu128, qv128, do128, k64, v64, p64;
  if (!encode_map(&qu64, qu, B, T_len, H, 64) || !encode_map(&qv64, qv, B, T_len, H, 64) ||
      !encode_map(&do64, dout, B, T_len, H, 64) || !encode_map(&k128, k, B, T_len, H, 128) ||
      !encode_map(&v128, v, B, T_len, H, 128) || !encode_map(&qu128, qu, B, T_len, H, 128) ||
      !encode_map(&qv128, qv, B, T_len, H, 128) ||
      !encode_map(&do128, dout, B, T_len, H, 128) || !encode_map(&k64, k, B, T_len, H, 64) ||
      !encode_map(&v64, v, B, T_len, H, 64) ||
      !encode_map(&p64, pos, 1, 2 * T_len - 1, H, kBChunk))
    return cudaErrorInvalidValue;

  dim3 grid_kv((T_len + 127) / 128, H, B);
  relpos_dkdv_kernel<<<grid_kv, kThreads, kDkdvSmem, st>>>(
      qu64, qv64, k128, v128, do64, p64, delta, lse2, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T_len, H, Tpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((T_len + 127) / 128, H, B);
  relpos_dq_kernel<<<grid_q, kThreads, kDqSmem, st>>>(
      qu128, qv128, k64, v64, do128, p64, delta, lse2, static_cast<bf16*>(dqu),
      static_cast<bf16*>(dqv), T_len, H, Tpad);
  return cudaGetLastError();
}
