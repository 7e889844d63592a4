// K5 — the positional conv on Hopper: the grouped long convolution of
// wav2vec2's positional embedding, bf16 in the model's (B, T, H) layout, as
// one implicit-GEMM kernel that computes both the forward and the input
// gradient.
//
// What it replaces. No TPU kernel: the JAX package runs this layer through
// lax.conv_general_dilated (paa_tpu/models/wav2vec2.py:535-573), which XLA
// lowers for the TPU itself. On the H100 the same layer went to cuDNN through
// F.conv1d on a (B, C, T) transpose, and cuDNN's grouped input gradient
// (void_dgrad_engine<bf16, 128, 6, 7, 3, 3, 5, ...>) took about 567 ms of a
// base attack batch for 0.6 TFLOP of work, 0.05 % of the card's bf16 peak,
// its forward 1-3 %. The layer is 16 groups of 48 (base) or 64 (lv60)
// channels over 128 taps: a small product repeated for every tap, which no
// library call sees as one matrix product.
//
// What it computes. With P = K/2 and Cg = H/G channels a group,
//   forward:  pre[b,t,g·Cg+co] = Σ_k Σ_ci x[b, t+k−P, g·Cg+ci]·W[g·Cg+co, ci, k] + bias
//             out = gelu(pre), the exact erf GELU of F.gelu, both written;
//   gradient: dx[b,s,g·Cg+ci] = Σ_k' Σ_co dpre[b, s+k'−(K−1−P), g·Cg+co]·W[g·Cg+co, ci, K−1−k']
// for t, s in [0, T): the same sum with the taps flipped, the group's
// weight transposed and the offset K−1−P. A row outside [0, T) reads as 0,
// which is the padding and, for even K, the frame that SamePad trims (it is
// never computed). bf16 operands, float32 sums, one rounding to bf16.
//
// What bounds it on the H100: 2·B·T·H·Cg·K operations against a few
// (B, T, H) bf16 activations, so the tensor cores: 301.4 GFLOP (0.305 ms at
// 989 TFLOP/s) for base's batch (64, 499, 768, G 16, K 128), 536.3 GFLOP
// (0.542 ms) for an lv60 microbatch (32, 999, 1024), in each direction.
//
// Design: wgmma with both operands in shared memory, the output's channels as
// the M side and frames as the N side.
//   - The tile. A block owns FB frames of one (clip, group): grid
//     (⌈T/FB⌉, G, B), 288 threads. Warpgroups 0 and 1 are consumers, NW =
//     FB/2 frames each; warp 8 is the producer. With Cg ≤ 64 a consumer runs
//     m64n256k16 (MT = 1: the Cg output channels padded to 64 rows, FB = 512);
//     with 64 < Cg ≤ 128 two m64n128k16 (MT = 2, FB = 256). Either way its
//     accumulator is 128 float32 registers. The reduction runs over K taps ×
//     Cg input channels in steps of 16.
//   - The window. The producer loads the block's input window, FB + 128 rows
//     × Cg, once, by TMA from a 3-D tensor map over (H, T, B) with boxes of
//     (8 channels, 128 rows), no swizzle: plane c of shared memory holds
//     channels 8c … 8c+7 of every window row, 16 bytes a row. TMA fills rows
//     outside the clip with zeros, and the negative start row −P is the
//     padding.
//   - The shift per tap. In that layout an 8-row × 16-byte core matrix is
//     128 contiguous bytes wherever it starts, so tap k is the window's
//     descriptor moved by 16·k bytes: no copy, no ldmatrix, no phase copies
//     of the window (wgmma's swizzled layouts tie a tile to 8-row atoms and
//     cannot be moved by one row). The window is the B operand, K-major:
//     channel planes WR·16 bytes apart (LBO), 8-row groups 128 bytes (SBO).
//   - The weight. The wrapper packs each group's taps in the same core-matrix
//     layout, tap k as (Cg/8 planes) × (64·MT rows) × 16 bytes, zero rows past
//     Cg (pos_conv.py:pack_taps; (G, K, Cg, Cg) bf16 plus the padding, 12.6 MB
//     at base and 16.8 MB at lv60). The producer streams tap after tap with
//     one bulk copy each through a ring of full/empty mbarriers; the tap is
//     the A operand of every wgmma of both consumers, so each block reads its
//     group's weight once for FB frames, FB operations a byte of weight
//     (at base 1024 blocks of 786 KB: 0.8 GB from L2 a call).
//   - The epilogue. Accumulator (co, frame) pairs go straight to the (B, T,
//     H) outputs: the forward adds the bias, rounds pre to bf16 and writes
//     it and gelu(pre); the gradient writes dx. Nothing is transposed.
// The host entry points return cudaGetLastError() after the launch, and the
// wrapper raises on anything but 0, as for the other kernels.
#include "attention_sm90.cuh"

namespace paa {
namespace posconv {
namespace {

using sm90::bf16;

constexpr int kConsumers = 256;            // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxK = 128;                 // taps
constexpr int kMaxCg = 128;                // channels a group
constexpr int kBoxRows = 128;              // rows of one TMA box
constexpr int kCoreBytes = 128;            // an 8-row × 16-byte core matrix
constexpr float kSqrtHalf = 0.70710678118654752440f;

template <int MT>
struct Tile {
  static constexpr int NW = 256 / MT;       // frames a consumer warpgroup
  static constexpr int FB = 2 * NW;         // frames a block
  static constexpr int WR = FB + kMaxK;     // window rows (≥ FB + K − 1)
  static constexpr int M = 64 * MT;         // weight rows of a tap: Cg padded
  static constexpr int S = MT == 1 ? 8 : 3;  // weight ring stages
  static_assert(WR % kBoxRows == 0, "the window is loaded in whole boxes");

  __host__ __device__ static constexpr int window_bytes(int cg) { return cg * WR * 2; }
  __host__ __device__ static constexpr int tap_bytes(int cg) { return cg * M * 2; }
  // + the mbarriers and the slack to align the window at 1024 bytes
  __host__ __device__ static constexpr int smem_bytes(int cg) {
    return window_bytes(cg) + S * tap_bytes(cg) + (1 + 2 * S) * 8 + 1024;
  }
};

// Descriptor of a K-major operand without swizzle starting at `p`: core
// matrices adjacent in K `lbo` bytes apart, adjacent in M or N `sbo` bytes.
__device__ __forceinline__ uint64_t desc_plain(const void* p, uint32_t lbo, uint32_t sbo) {
  return ((sm90::smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t{(lbo >> 4) & 0x3FFF} << 16) |
         (uint64_t{(sbo >> 4) & 0x3FFF} << 32);
}

// D[64][256] += A[64][16]·B[16][256]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 256) {
    wgmma_ss_n256(d, da, db);
  } else {
    static_assert(N == 128, "frames a warpgroup: 256 or 128");
    sm90::wgmma_ss_n128(d, da, db, 1);
  }
}

// x, y0, y1: (B, T, H) bf16; wpack: (G, K, Cg/8, 64·MT, 8) bf16; the
// forward adds bias (H,) and writes pre to y0 and gelu(pre) to y1, the
// gradient writes dx to y0. Input row t + k − offset feeds output row t at
// tap k.
template <int MT, bool kFwd>
__global__ void __launch_bounds__(kThreads, 1)
pos_conv_kernel(const __grid_constant__ CUtensorMap map_x, const bf16* __restrict__ wpack,
                const bf16* __restrict__ bias, bf16* __restrict__ y0, bf16* __restrict__ y1,
                int T_len, int H, int Cg, int K, int offset) {
  using C = Tile<MT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int planes = Cg / 8;
  const int tap_bytes = C::tap_bytes(Cg);
  unsigned char* win = base;
  unsigned char* ring = base + C::window_bytes(Cg);
  uint64_t* win_full = reinterpret_cast<uint64_t*>(ring + C::S * tap_bytes);
  uint64_t* full = win_full + 1;
  uint64_t* empty = full + C::S;

  const int t0 = blockIdx.x * C::FB;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(win_full, 1);
    for (int s = 0; s < C::S; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // producer
    if (lane == 0) {
      sm90::mbar_expect_tx(win_full, C::window_bytes(Cg));
      for (int p = 0; p < planes; ++p)
        for (int j = 0; j < C::WR / kBoxRows; ++j)
          sm90::tma_load_3d(win + (p * C::WR + j * kBoxRows) * 16, &map_x, g * Cg + 8 * p,
                            t0 - offset + j * kBoxRows, b, win_full);
      const unsigned char* taps =
          reinterpret_cast<const unsigned char*>(wpack) + static_cast<size_t>(g) * K * tap_bytes;
      for (int k = 0; k < K; ++k) {
        const int s = k % C::S;
        sm90::mbar_wait(&empty[s], ((k / C::S) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], tap_bytes);
        sm90::bulk_load(ring + s * tap_bytes, taps + static_cast<size_t>(k) * tap_bytes,
                        tap_bytes, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns frames t0 + NW·wg …
  const int wg = warp / 4;
  float acc[MT][C::NW / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < C::NW / 2; ++i) acc[mt][i] = 0.0f;

  const uint32_t win_lbo = C::WR * 16;  // the next 8 channels: the next plane
  const uint32_t tap_lbo = C::M * 16;
  const int ksteps = Cg / 16;
  sm90::mbar_wait(win_full, 0);
  for (int k = 0; k < K; ++k) {
    const int s = k % C::S;
    sm90::mbar_wait(&full[s], (k / C::S) & 1);
    sm90::wgmma_fence();
    // tap k: the window moved down by k rows, 16 bytes a row
    const unsigned char* bk = win + (wg * C::NW + k) * 16;
    const unsigned char* ak = ring + s * tap_bytes;
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint64_t db = desc_plain(bk + 2 * kk * win_lbo, win_lbo, kCoreBytes);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_ss<C::NW>(acc[mt], desc_plain(ak + 2 * kk * tap_lbo + mt * 64 * 16, tap_lbo,
                                             kCoreBytes),
                        db);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // tap k − 1's products are done: free its stage
    if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % C::S]);
  }
  sm90::wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) sm90::reg_fence(acc[mt]);

  // accumulator i of this thread: output channel 16·(warp mod 4) + lane/4 +
  // 8·((i/2) mod 2) of the co tile, frame 8·(i/4) + 2·(lane mod 4) + (i mod 2)
  const int f0 = t0 + wg * C::NW + 2 * (lane % 4);
  const size_t clip = static_cast<size_t>(b) * T_len;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int co[2];
    float bv[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      co[r] = mt * 64 + 16 * (warp % 4) + lane / 4 + 8 * r;
      if (kFwd && co[r] < Cg) bv[r] = __bfloat162float(bias[g * Cg + co[r]]);
    }
#pragma unroll
    for (int i = 0; i < C::NW / 2; ++i) {
      const int r = (i / 2) % 2;
      const int f = f0 + 8 * (i / 4) + (i % 2);
      if (co[r] < Cg && f < T_len) {
        const size_t idx = (clip + f) * H + g * Cg + co[r];
        if (kFwd) {
          const bf16 pre = __float2bfloat16_rn(acc[mt][i] + bv[r]);
          const float v = __bfloat162float(pre);
          y0[idx] = pre;
          y1[idx] = __float2bfloat16_rn(v * 0.5f * (1.0f + erff(v * kSqrtHalf)));
        } else {
          y0[idx] = __float2bfloat16_rn(acc[mt][i]);
        }
      }
    }
  }
}

// The tensor map of a (B, T, H) bf16 activation: dims (H, T, B), boxes of 8
// channels × 128 rows, no swizzle, rows outside [0, T) read as zeros.
bool encode_window_map(CUtensorMap* map, const void* ptr, int B, int T_len, int H) {
  sm90::EncodeTiled fn = sm90::encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(H) * 2,
                                 static_cast<cuuint64_t>(T_len) * H * 2};
  const cuuint32_t box[3] = {8, kBoxRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, bool kFwd>
int launch(const void* x, const void* wpack, const void* bias, void* y0, void* y1, int B,
           int T_len, int H, int Cg, int K, int offset, void* stream) {
  using C = Tile<MT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = sm90::allow_smem(pos_conv_kernel<MT, kFwd>, C::smem_bytes(64 * MT));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap map;
  if (!encode_window_map(&map, x, B, T_len, H)) return cudaErrorInvalidValue;
  dim3 grid((T_len + C::FB - 1) / C::FB, H / Cg, B);
  pos_conv_kernel<MT, kFwd><<<grid, kThreads, C::smem_bytes(Cg), static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const bf16*>(wpack), static_cast<const bf16*>(bias), static_cast<bf16*>(y0),
      static_cast<bf16*>(y1), T_len, H, Cg, K, offset);
  return cudaGetLastError();
}

template <bool kFwd>
int dispatch(const void* x, const void* wpack, const void* bias, void* y0, void* y1, int B,
             int T_len, int H, int Cg, int K, int offset, void* stream) {
  if (B < 1 || T_len < 1 || Cg < 16 || Cg > kMaxCg || Cg % 16 || H % Cg || K < 1 || K > kMaxK)
    return cudaErrorInvalidValue;
  if (Cg <= 64) return launch<1, kFwd>(x, wpack, bias, y0, y1, B, T_len, H, Cg, K, offset, stream);
  return launch<2, kFwd>(x, wpack, bias, y0, y1, B, T_len, H, Cg, K, offset, stream);
}

}  // namespace
}  // namespace posconv
}  // namespace paa

// x, pre, out: (B, T, H) contiguous bfloat16, 16-byte aligned; wpack: the
// taps as pos_conv.py:pack_taps lays them out; bias: (H,) bfloat16.
extern "C" int paa_pos_conv_fwd(const void* x, const void* wpack, const void* bias, void* pre,
                                void* out, int B, int T_len, int H, int Cg, int K, void* stream) {
  return paa::posconv::dispatch<true>(x, wpack, bias, pre, out, B, T_len, H, Cg, K, K / 2,
                                      stream);
}

// dpre, dx: (B, T, H) contiguous bfloat16, 16-byte aligned; wpack: the
// flipped, group-transposed taps (pos_conv.py:dgrad_taps) as pack_taps lays
// them out.
extern "C" int paa_pos_conv_dgrad(const void* dpre, const void* wpack, void* dx, int B, int T_len,
                                  int H, int Cg, int K, void* stream) {
  return paa::posconv::dispatch<false>(dpre, wpack, nullptr, dx, nullptr, B, T_len, H, Cg, K,
                                       K - 1 - K / 2, stream);
}
