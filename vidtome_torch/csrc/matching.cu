// Best match of cosine scores for Hopper (sm_90a): per src row, the max
// score over all dst rows and the lowest dst index that reaches it.
//
// Replaces vidtome_tpu/ops/matching.py:best_match (_match_kernel).
// out_max[b, s] = max_d <src[b, s], dst[b, d]>, out_idx[b, s] = the
// smallest such d, with bf16 operands and fp32 accumulation.  The [S, D]
// score matrix never leaves the SM.
//
// Shapes on the main path (SD1.5 at 512x512, chunk 4, target stride 4):
// the local rounds match [2, 12288, 320] against [2, 4096, 320] (level 0)
// and [2, 3072, 640] against [2, 1024, 640] (level 1); the global merge
// matches the locally merged chunk against the bank ([2, 4711, 320] both
// at level 0 of the serving profile).  Each score is C multiply-adds and
// is read once, so the tensor cores bound the kernel (64 GFLOP at the
// level-0 round: 0.065 ms at 989 TFLOP/s), not the bytes (13 MB).
//
// Design:
//  * one block = NW consumer warpgroups of 64 src rows each (64, 128 or
//    192 rows of one batch element; ops/matching.match_plan picks NW from
//    the shape and the SM count so the grid's last wave is not mostly
//    empty) and one producer warpgroup, of which one thread issues every
//    TMA copy.  All consumers read the same dst stream, so each dst tile
//    crosses L2 once per 64 * NW src rows.  They run near lockstep on
//    that shared ring, so their compare/select epilogues overlap each
//    other more than the products: without them the level-0 rows take
//    14-19% less time (flash_ab.py, PERF.md);
//  * the src tile: loaded once by TMA as C / 64 boxes of [64 channels x
//    64 NW rows] in 128-byte swizzle (the map views src as [B, 1, S, C]),
//    and kept in shared memory for the whole sweep over dst
//    (RESIDENT); where it does not fit beside the ring (C > 640 at 128
//    rows, > 1280 at 64), each ring stage carries the src box of its
//    channel chunk beside the dst box instead, read again per dst tile;
//  * dst flows through a 4-stage mbarrier ring of [128 dst rows x 64
//    channels] boxes (full / empty barriers), one box a (dst tile, channel
//    chunk) step.  TMA fills rows past D and channels past C with zeros,
//    so a ragged D or C takes no branch in the main loop;
//  * scores: wgmma m64n128k16, both operands K-major from shared memory,
//    fp32 accumulators, summed over the channel chunks of a tile; each
//    chunk's stage is released once the next chunk's products are issued
//    and its own are done (wgmma.wait_group 1);
//  * the running (max, argmax) stays in registers, read straight from the
//    accumulator layout (hopper.cuh): each thread holds 2 rows, scans its
//    32 columns of a row in increasing order with a strict '>' (`better`),
//    and the dst tiles in order, so it keeps the lowest index among exact
//    ties; the four threads of a row combine with "greater, or equal and
//    lower index" -- ties go to the lowest dst index, as jnp.argmax and the
//    TPU kernel do.  Columns at or past D are set to -inf first: a
//    zero-filled dst row scores exactly 0, which would beat a row whose
//    true scores are all negative.
//
// src and dst are contiguous [B, S, C] / [B, D, C] with 16-byte aligned
// bases and C a multiple of 8 up to 1728 (TMA's rules: rows of whole 16
// bytes; the Python wrapper checks them).  The C entry returns 0, a cudaError_t code, -1 for arguments it
// does not take, -2 when CUDA offers no cuTensorMapEncodeTiled and -3
// when it refuses a map; the Python wrapper raises on anything but 0.

#include "hopper.cuh"

namespace {

constexpr int kAtom = 64;     // bf16 channels of one 128-byte swizzle row
constexpr int kBD = 128;      // dst rows a tile: the N of one wgmma
constexpr int kStages = 4;    // the ring
constexpr int kMaxC = 1728;
constexpr int kSmemMax = 232448;  // a block's shared memory on Hopper
constexpr uint32_t kDstBox = kBD * 128;  // one dst box: 128 rows x 128 bytes

// NW consumer warpgroups, the src tile resident or streamed by the ring.
template <int NW, bool RESIDENT>
struct Tiles {
  static constexpr int BM = 64 * NW;              // src rows a block
  static constexpr int CONSUMERS = 128 * NW;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer
  static constexpr uint32_t SRC_BOX = BM * 128;    // [64 channels x BM rows]
  static constexpr uint32_t STAGE = kDstBox + (RESIDENT ? 0 : SRC_BOX);
  static_assert(SRC_BOX % 1024 == 0 && STAGE % 1024 == 0,
                "boxes keep the 1024-byte swizzle span");
  // the src tile (resident), the ring, full / empty / src barriers, slack
  // to align the base to the swizzle span; as ops/matching.match_plan
  static size_t smem(int atoms) {
    return (RESIDENT ? (size_t)atoms * SRC_BOX : 0) + kStages * STAGE +
           8 * (2 * kStages + 1) + 1024;
  }
};

// Whether score v displaces the running best m: strict, so that among
// equal scores the first seen (the lowest index) stays.
__device__ __forceinline__ bool better(float v, float m) { return v > m; }

template <int NW, bool RESIDENT>
__global__ void __launch_bounds__(Tiles<NW, RESIDENT>::THREADS, NW == 1 ? 2 : 1)
best_match_kernel(const __grid_constant__ CUtensorMap tm_src,
                  const __grid_constant__ CUtensorMap tm_dst,
                  float* __restrict__ out_max, long long* __restrict__ out_idx,
                  int S, int D, int atoms) {
  using T = Tiles<NW, RESIDENT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t src_tile = base;  // RESIDENT: `atoms` src boxes
  const uint32_t ring = base + (RESIDENT ? atoms * T::SRC_BOX : 0u);
  const uint32_t full = ring + kStages * T::STAGE;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;
  const uint32_t src_full = empty + 8 * kStages;

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * T::BM;
  const int b = blockIdx.y;
  const int n_tiles = (D + kBD - 1) / kBD;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NW);  // one arrival a consumer warp
    }
    mbar_init(src_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // the producer: the src tile once, then one ring stage a (dst tile,
    // channel chunk) step in the consumers' order, kStages ahead
    if (tid == T::CONSUMERS) {
      if (RESIDENT) {
        mbar_expect_tx(src_full, atoms * T::SRC_BOX);
        for (int a = 0; a < atoms; ++a) {
          tma_load(src_tile + a * T::SRC_BOX, &tm_src, src_full, a * kAtom,
                   s0, 0, b);
        }
      }
      int s = 0;
      uint32_t phase = 0;
      for (int tile = 0; tile < n_tiles; ++tile) {
        for (int a = 0; a < atoms; ++a) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t stage = ring + s * T::STAGE;
          mbar_expect_tx(full + 8 * s, T::STAGE);
          tma_load(stage, &tm_dst, full + 8 * s, a * kAtom, tile * kBD, 0, b);
          if (!RESIDENT) {
            tma_load(stage + kDstBox, &tm_src, full + 8 * s, a * kAtom, s0, 0,
                     b);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t a_rows = wg * 64 * 128;  // this warpgroup's rows of a box

  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {0, 0};
  if (RESIDENT) mbar_wait_warp(src_full, 0);
  int s = 0, prev = 0;
  uint32_t phase = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // scores of this warpgroup's 64 rows x the tile's 128 dst rows, summed
    // over the channel chunks: a k16 step moves 32 bytes inside the atom
    for (int a = 0; a < atoms; ++a) {
      mbar_wait_warp(full + 8 * s, phase);
      const uint32_t stage = ring + s * T::STAGE;
      const uint32_t at =
          (RESIDENT ? src_tile + a * T::SRC_BOX : stage + kDstBox) + a_rows;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_ss(acc, smem_desc(at + ks * 32, 16, 1024),
                 smem_desc(stage + ks * 32, 16, 1024), a > 0 || ks > 0);
      }
      wgmma_commit();
      // the previous chunk's products are done: its stage is free
      wgmma_wait_1();
      if (a > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // d[4j + e]: row g + 8 (e >> 1), column 8j + 2t + (e & 1) of the tile
    const int d0 = tile * kBD;
    if (d0 + kBD > D) {  // the ragged last tile: zero-filled rows never win
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int col = d0 + (e / 4) * 8 + 2 * t + (e & 1);
        if (col >= D) acc[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // this thread's columns of the row in increasing order; k is the
      // column less 2t, an immediate
      float m = acc[2 * r];
      int k = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = (j == 0); c < 2; ++c) {
          const float v = acc[4 * j + 2 * r + c];
          if (better(v, m)) {
            m = v;
            k = 8 * j + c;
          }
        }
      }
      if (better(m, best[r])) {
        best[r] = m;
        bidx[r] = d0 + 2 * t + k;
      }
    }
  }

  // combine the four threads of a row: greater, or equal and lower index
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[r], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[r], off);
      if (ov > best[r] || (ov == best[r] && oi < bidx[r])) {
        best[r] = ov;
        bidx[r] = oi;
      }
    }
  }
  if (t == 0) {
    const int row0 = s0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < S) {
        out_max[(long long)b * S + row] = best[r];
        out_idx[(long long)b * S + row] = bidx[r];
      }
    }
  }
}

// ---- host ----

// The map of a contiguous [B, rows, C] operand seen as [B, 1, rows, C],
// box [64 channels x box rows].
int operand_map(CUtensorMap* map, const void* ptr, int C, int rows, int B,
                int box) {
  const long long st[3] = {(long long)rows * C, (long long)rows * C, C};
  return encode(map, ptr, C, rows, 1, B, st, box);
}

template <int NW, bool RESIDENT>
int launch(const void* src, const void* dst, float* out_max,
           long long* out_idx, int B, int S, int D, int C,
           cudaStream_t stream) {
  using T = Tiles<NW, RESIDENT>;
  auto kern = best_match_kernel<NW, RESIDENT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (attr != cudaSuccess) return (int)attr;
  const int atoms = (C + kAtom - 1) / kAtom;
  const size_t smem = T::smem(atoms);
  if (smem > (size_t)kSmemMax) return -1;
  CUtensorMap tm_src, tm_dst;
  int err = operand_map(&tm_src, src, C, S, B, T::BM);
  if (err == 0) err = operand_map(&tm_dst, dst, C, D, B, kBD);
  if (err != 0) return err;
  const dim3 grid((S + T::BM - 1) / T::BM, B);
  kern<<<grid, T::THREADS, smem, stream>>>(tm_src, tm_dst, out_max, out_idx,
                                           S, D, atoms);
  return (int)cudaGetLastError();
}

}  // namespace

// src [B, S, C], dst [B, D, C] bf16 contiguous -> out_max [B, S] fp32,
// out_idx [B, S] int64.  rows: src rows a block (64, 128 or 192);
// resident: 1 to keep the src tile in shared memory, 0 to stream it beside
// dst (ops/matching.match_plan).
extern "C" int vidtome_best_match(const void* src, const void* dst,
                                  void* out_max, void* out_idx, int B, int S,
                                  int D, int C, int rows, int resident,
                                  void* stream) {
  if (C % 8 != 0 || C <= 0 || C > kMaxC || S <= 0 || D <= 0 || B <= 0 ||
      B > 65535) {
    return -1;
  }
  float* mx = static_cast<float*>(out_max);
  long long* ix = static_cast<long long*>(out_idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows * 2 + (resident != 0)) {
    case 64 * 2 + 1: return launch<1, true>(src, dst, mx, ix, B, S, D, C, s);
    case 64 * 2: return launch<1, false>(src, dst, mx, ix, B, S, D, C, s);
    case 128 * 2 + 1: return launch<2, true>(src, dst, mx, ix, B, S, D, C, s);
    case 128 * 2: return launch<2, false>(src, dst, mx, ix, B, S, D, C, s);
    case 192 * 2 + 1: return launch<3, true>(src, dst, mx, ix, B, S, D, C, s);
    case 192 * 2: return launch<3, false>(src, dst, mx, ix, B, S, D, C, s);
    default: return -1;
  }
}
