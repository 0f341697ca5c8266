// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces vidtome_tpu/ops/attention.py:flash_attention (_flash_kernel).
// out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h] over the first
// kv_len keys, with fp32 running max / sum and deferred normalisation.
//
// Shape of the work on the main paths: head dims 40 and 80 in the SD1.5
// UNet, 64 in SD2.1's, 512 (one head) in the VAE mid block; merged
// self-attention over 1536..6144 tokens and per-frame attention over 4096.
// q, k and v are read once per query tile and the [S, S] scores never
// leave the SM, so bytes bound nothing.  What does:
//  * at D = 40 the exponentials: one exp2 per score on the special-function
//    units takes longer than the two products of that score on the tensor
//    cores, even with D padded to 64;
//  * at D >= 64 and at D = 512 the tensor cores.
//
// Design:
//  * one block = two or three consumer warpgroups, no producer warp.  For
//    D <= 192 each warpgroup owns 64 query rows and every output column:
//    three (192 rows) at D = 40 and 80, whose rows are not whole 128-byte
//    lines, so each K/V tile serves more queries; two (128 rows) at D = 64
//    and 160 (the dispatch at the end of this file says what was measured);
//  * thread 0 issues the first copies with TMA: the Q tile once, and the
//    first K and V tiles into a 2-stage ring of shared-memory buffers, each
//    with a "full" mbarrier (expect_tx: the copy's bytes) for K and one for
//    V.  When a warp is done with a stage it adds one to the stage's count
//    in shared memory, and the last warp of the block to do so refills the
//    stage with tile i + 2, so no warp waits for another: a thread that
//    waited for all warps before each refill would hold the warpgroups in
//    lock step, with their softmaxes at the same time (measured slower).
//    The copy overlaps the products of tile i + 1;
//  * tiles sit in shared memory in 128-byte swizzle atoms of 64 bf16
//    columns, D padded up to a multiple of 64 (40 -> 64, 80 -> 128,
//    160 -> 192): TMA zero-fills the columns past D and the keys past
//    kv_len, so no host pass pads anything;
//  * S = Q K^T is wgmma.mma_async m64nBKk16 with both operands in
//    shared memory, K-major: 128 keys a tile at D <= 64, 64 at D >= 80, so
//    the score accumulator stays at 64 registers a thread or fewer;
//  * the online softmax runs in fp32 registers (scale folded into the
//    exponent, keys at or past kv_len masked to -1e30, row max and sum
//    across the 4 threads of a row by shuffles, exp2 as one ex2.approx.ftz
//    on the special-function unit).  The fp32 accumulator layout of
//    m64nNk16 is, packed to bf16, the register A fragment of the next k16
//    step, so P = exp(S) never leaves registers;
//  * O += P V is wgmma with A = P from registers and B = V from shared
//    memory, MN-major (the transpose flag), 64 output columns an
//    instruction; O is rescaled by the running max in registers between
//    the two products (wgmma.wait_group, then wgmma.fence before the next
//    product reads it).  A warpgroup waits for each of its products;
//    while it runs its softmax, the other warpgroups' products keep the
//    tensor cores busy;
//  * D = 512 (the VAE): 64 query rows a block, the two warpgroups split the
//    output columns (256 each, 128 fp32 accumulators a thread) and the
//    depth of Q K^T: each computes the 64 x 32 scores over its half of D,
//    and the two halves are added through shared memory (one named barrier
//    a tile), so every score is computed once.  Q (64 KB), a 2-stage ring
//    of 32-key K and V tiles (2 x 64 KB) and the partial scores (32 KB) fit
//    in shared memory;
//  * cudaFuncSetAttribute runs once per kernel instance, not per launch.
//
// Inputs may be strided views ([B, S, H, D] projections seen as
// [B, H, S, D]): the innermost dimension must be contiguous, every stride
// a multiple of 16 bytes and the base 16-byte aligned (TMA's rules; the
// Python wrapper checks them).  The C entry point returns 0, a cudaError_t
// code, or a negative code of its own (see vidtome_flash_attention); the
// Python wrapper raises on anything but 0.

#include "hopper.cuh"

namespace {

constexpr int kAtom = 64;      // bf16 columns of one 128-byte swizzle atom
constexpr int kStages = 2;     // K/V ring depth
constexpr float kNegBig = -1e30f;

// Per instance: D padded to DP, BK keys a tile, WGS consumer warpgroups of
// 64 query rows each, except at D = 512 (SPLIT), where two warpgroups share
// 64 rows.
template <int DP, int BK, int WGS>
struct Tiles {
  static constexpr bool SPLIT = DP == 512;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BQ = SPLIT ? 64 : 64 * WGS;  // query rows a block
  static constexpr int NA = DP / kAtom;           // swizzle atoms across D
  static constexpr int DV = SPLIT ? DP / 2 : DP;  // output columns a warpgroup
  static constexpr uint32_t Q_ATOM = BQ * 128;    // bytes of one atom column
  static constexpr uint32_t KV_ATOM = BK * 128;
  static constexpr uint32_t Q_BYTES = NA * Q_ATOM;
  static constexpr uint32_t KV_BYTES = NA * KV_ATOM;  // one K or V tile
  // SPLIT: each warpgroup's partial scores (fp32, 64 x BK), two tiles deep
  static constexpr uint32_t XCH_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr uint32_t XCH_BYTES = SPLIT ? 2 * 2 * BK * 64 * 4 : 0;
  static constexpr uint32_t BAR_OFF = XCH_OFF + XCH_BYTES;
  // + 5 mbarriers and a count of the warps done with each stage, + slack
  // to align the base to the 1024-byte swizzle span
  static constexpr size_t SMEM = BAR_OFF + 64 + 1024;
};

template <int DP, int BK, int WGS>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t sK,
                                        uint32_t sV, uint32_t bar, int tile,
                                        int h, int b) {
  using T = Tiles<DP, BK, WGS>;
  const int s = tile % kStages;
  const uint32_t k_full = bar + 8u * (1 + s);
  const uint32_t v_full = bar + 8u * (3 + s);
  mbar_expect_tx(k_full, T::KV_BYTES);
#pragma unroll
  for (int a = 0; a < T::NA; ++a) {
    tma_load(sK + s * T::KV_BYTES + a * T::KV_ATOM, tm_k, k_full, a * kAtom,
             tile * BK, h, b);
  }
  mbar_expect_tx(v_full, T::KV_BYTES);
#pragma unroll
  for (int a = 0; a < T::NA; ++a) {
    tma_load(sV + s * T::KV_BYTES + a * T::KV_ATOM, tm_v, v_full, a * kAtom,
             tile * BK, h, b);
  }
}

// Barriers at `bar`: [0] Q full, [1 + s] K full, [3 + s] V full; after them
// (bar + 40) done[s], the warps done with ring stage s.
template <int DP, int BK, int WGS>
__global__ void __launch_bounds__(Tiles<DP, BK, WGS>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ o, int H, int Sq, int kv_len,
                 int D, long long o_sb, long long o_sh, long long o_ss,
                 float scale_log2) {
  using T = Tiles<DP, BK, WGS>;
  constexpr bool SPLIT = T::SPLIT;
  constexpr int NS = BK / 2;        // score accumulators a thread
  constexpr int NO = T::DV / kAtom;  // 64-column output chunks a warpgroup
  constexpr int KS = SPLIT ? DP / 32 : DP / 16;  // k16 steps of Q K^T

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;             // kStages K tiles
  const uint32_t sV = sK + kStages * T::KV_BYTES;  // kStages V tiles
  const uint32_t bar = sQ + T::BAR_OFF;
  unsigned char* base = smem_raw + (sQ - smem_u32(smem_raw));
  float* xch = reinterpret_cast<float*>(base + T::XCH_OFF);
  uint32_t* done = reinterpret_cast<uint32_t*>(base + T::BAR_OFF + 40);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * T::BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int n_tiles = (kv_len + BK - 1) / BK;
  const int row0 = SPLIT ? 0 : 64 * wg;     // warpgroup's first query row
  const int col0 = SPLIT ? T::DV * wg : 0;  // and first output column
  const int a0 = SPLIT ? wg * T::NA / 2 : 0;  // first atom of D in Q K^T

  if (tid == 0) {
    mbar_init(bar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8u * (1 + s), 1);
      mbar_init(bar + 8u * (3 + s), 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, T::Q_BYTES);
#pragma unroll
    for (int a = 0; a < T::NA; ++a) {
      tma_load(sQ + a * T::Q_ATOM, &tm_q, bar, a * kAtom, q0, h, b);
    }
    for (int i = 0; i < kStages && i < n_tiles; ++i) {
      load_kv<DP, BK, WGS>(&tm_k, &tm_v, sK, sV, bar, i, h, b);
    }
  }
  __syncwarp();

  float acc[NO][32];
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  }
  float sc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  uint32_t pa[BK / 16][4];
  float m_run[2] = {kNegBig, kNegBig};  // running row max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const uint32_t q_rows = sQ + row0 * 128;

  mbar_wait_warp(bar, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const uint32_t k_tile = sK + s * T::KV_BYTES;
    const uint32_t v_tile = sV + s * T::KV_BYTES;

    // S = Q K^T: [64 x BK] a warpgroup, KS steps of k16 (SPLIT: over this
    // warpgroup's half of D).  Inside an atom a k16 step moves the start
    // address by 32 bytes.
    mbar_wait_warp(bar + 8u * (1 + s), phase);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      const int a = a0 + ks / 4;
      wgmma_ss(sc, smem_desc(q_rows + a * T::Q_ATOM + off, 16, 1024),
               smem_desc(k_tile + a * T::KV_ATOM + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if (SPLIT) {
      // The two half-depth sums meet in shared memory: thread j of each
      // warpgroup holds the same scores.  Both add in the same pair, so both
      // get the same bits; slots alternate by tile, so a slot is rewritten
      // only after the next tile's barrier, when it has been read.
      float* mine = xch + ((i & 1) * 2 + wg) * NS * 128 + tid % 128;
      const float* theirs = xch + ((i & 1) * 2 + 1 - wg) * NS * 128 + tid % 128;
#pragma unroll
      for (int e = 0; e < NS; ++e) mine[e * 128] = sc[e];
      asm volatile("bar.sync 1, %0;\n" ::"n"(T::THREADS) : "memory");
#pragma unroll
      for (int e = 0; e < NS; ++e) sc[e] += theirs[e * 128];
    }

    // Online softmax over the tile, rows g and g + 8 of this warp's 16.
    const int kv0 = i * BK;
    if (kv0 + BK > kv_len) {
#pragma unroll
      for (int e = 0; e < NS; ++e) {
        const int col = kv0 + (e / 4) * 8 + 2 * t + (e & 1);
        if (col >= kv_len) sc[e] = kNegBig;
      }
    }
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      alpha[r] = exp2_ftz(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const int r = (e >> 1) & 1;
      sc[e] = exp2_ftz(fmaf(sc[e], scale_log2, -m_run[r]));
      l_run[r] += sc[e];
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      pa[ks][0] = pack_bf16(sc[8 * ks + 0], sc[8 * ks + 1]);
      pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
      pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
      pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
    }
#pragma unroll
    for (int c = 0; c < NO; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
    }

    // O += P V: k16 steps of 16 keys (2048 bytes of a V atom column), one
    // instruction per 64 output columns (one atom: LBO never applies).
    mbar_wait_warp(bar + 8u * (3 + s), phase);
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(acc[c]);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        const uint32_t atom = v_tile + (col0 / kAtom + c) * T::KV_ATOM;
        wgmma_rs(acc[c], pa[ks], smem_desc(atom + ks * 2048, 1024, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NO; ++c) fence_regs(acc[c]);
    fence_regs(pa);

    // Release the stage: the last warp of the block to be done with it
    // refills it with tile i + kStages.  No warp waits for another here.
    __syncwarp();
    if (lane == 0 && i + kStages < n_tiles) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1u) == T::THREADS / 32 - 1) {
        atomicExch(&done[s], 0u);
        __threadfence_block();
        load_kv<DP, BK, WGS>(&tm_k, &tm_v, sK, sV, bar, i + kStages, h, b);
      }
    }
    __syncwarp();
  }

  // Full row sums live across the 4 threads of a row.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  const int rows[2] = {q0 + row0 + 16 * warp + g, q0 + row0 + 16 * warp + g + 8};
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + c * kAtom + j * 8 + 2 * t;
      if (col >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] < Sq) {
          *reinterpret_cast<__nv_bfloat162*>(ob + rows[r] * o_ss + col) =
              __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * inv[r],
                                    acc[c][4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// ---- host ----

template <int DP, int BK, int WGS>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int kv_len, int D, const long long* st, float scale_log2,
           cudaStream_t stream) {
  using T = Tiles<DP, BK, WGS>;
  auto kern = flash_fwd_kernel<DP, BK, WGS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, D, Sq, H, B, st, T::BQ);
  if (err == 0) err = encode(&tk, k, D, kv_len, H, B, st + 3, BK);
  if (err == 0) err = encode(&tv, v, D, kv_len, H, B, st + 6, BK);
  if (err != 0) return err;
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, B * H);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Sq, kv_len, D, st[9],
      st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s) in elements.
// k and v are read up to row kv_len only.  Returns 0 on success, a
// cudaError_t code, -1 for an unsupported D, -2 when the driver has no
// cuTensorMapEncodeTiled, -3 when it refuses a tensor map.
extern "C" int vidtome_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Sq, int kv_len, int D,
                                       const long long* strides,
                                       float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Three warpgroups (192 query rows a block, each K/V tile read for more
  // queries) where a row of D is not whole 128-byte lines (D = 40, 80):
  // there the copies cost more, and this was measured faster; two at D = 64
  // and D > 128, where it was measured slower.
  switch ((D + kAtom - 1) / kAtom * kAtom) {
    case 64:
      return D == 64 ? launch<64, 128, 2>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s)
                     : launch<64, 128, 3>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 128: return launch<128, 64, 3>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 192: return launch<192, 64, 2>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 512: return launch<512, 32, 2>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    default: return -1;
  }
}
