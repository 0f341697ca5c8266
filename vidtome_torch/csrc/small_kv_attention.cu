// Single-pass attention over a short KV (at most 256 keys) for Hopper
// (sm_90a), bf16 in / bf16 out.
//
// Replaces vidtome_tpu/ops/attention.py:small_kv_attention
// (_small_kv_kernel): out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h]
// over the first kv_len keys, with the whole KV of one (batch, head) in one
// tile and one softmax pass (no running max, no rescale), scores in base 2,
// P normalised by its row sums before P V as the TPU kernel does.
//
// Shape of the work on the main paths: cross-attention against the 77
// text tokens at every level (SD1.5: D = 40, 80, 160; SD2.1: 64) and the
// unmerged self-attention of the 16x16 and 8x8 levels (256 and 64 keys).
// Every score's two products take 4 D operations against 4 D bytes of q
// and o per query row over tens of keys, so bytes bound the kernel: q read
// once, o written once, K and V (small) once per head.  The design's job
// is to keep HBM busy; the products only have to hide under the copies.
//
// Design:
//  * one block = one consumer warpgroup (128 threads), no producer warp:
//    thread 0 issues every copy.  A block walks a contiguous range of work
//    items (one 64-row Q tile of one (batch, head) each, heads outermost),
//    so K and V are staged once per head and range, by TMA, and staged
//    again only where the range enters the next head;
//  * grid: as many blocks as fit on the card at once (blocks per SM from
//    cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, queried
//    once per instance), each taking ceil(items / that) items, so every
//    block is resident from the start and no tail wave is left: at
//    [8,8,4096x77,40] about 8 tiles a block, at [8,8,256x256,160] (one
//    block an SM) 2, at the 64-query rows one (a block per head: fewer
//    blocks would only run the heads one after another).  Measured on an
//    H100 (flash_ab.py): 1.4-4.9x faster device-only than the mma.sync
//    kernel it replaced at every row of the main paths, and 5.4-7.0 us
//    device-only at the 64-query rows against SDPA's 10.3-10.8;
//  * Q tiles come in through a 2-stage ring (an mbarrier with expect_tx
//    a stage): the copy of item n + 2 is issued as soon as every warp has
//    read item n's Q (after Q K^T), so it runs under item n + 1;
//  * operands sit in shared memory in swizzle atoms: at D <= 64 one
//    128-byte atom of 64 bf16 columns (40 -> 64), so a Q or O row is one
//    TMA box; wider, 64-byte atoms of 32 columns, D padded up to a
//    multiple of 32 (80 -> 96, 160 -> 160).  TMA zero-fills the columns
//    past D, the rows past Sq and the keys past kv_len, so no host pass
//    pads anything and the padding costs no HBM bytes.  Atoms of 32
//    columns keep the widest case (256 keys, D = 160) at 221 KB: K and V
//    160 KB, two Q stages and the O staging tile 60 KB; padded to 192 it
//    would not fit;
//  * S = Q K^T is wgmma.mma_async m64n64k16 per 64 keys (m64n16k16 for the
//    last 16 of 80), both operands K-major from shared memory, fp32 in
//    registers (128 a thread at 256 keys);
//  * softmax in fp32 registers: the scale folded into the exponent, keys
//    at or past kv_len (zero-filled, so scoring 0, not -inf) masked to
//    -1e30, row max and sum across the 4 threads of a row by shuffles, exp2
//    as ex2.approx.ftz, P times 1/l packed to bf16 in the register A
//    fragments of P V;
//  * O = P V is wgmma m64nNk16 with N the atom's columns, A = P from registers,
//    B = V from shared memory, MN-major (the transpose flag).  S is dead
//    once P is packed, so at 256 keys and D = 160 the peak is S (128) or
//    P + O (64 + 80) registers, in one warpgroup: ptxas gives 182
//    registers a thread there, 76-180 to the other instances, no spills;
//  * epilogue by TMA store: O goes bf16 into a staging tile in the store
//    map's swizzle (conflict-free 4-byte writes), then out over the
//    [B, S, H, D] view, whole rows at a time; TMA clips the rows past Sq
//    and the columns past D.  The store runs under the next item; thread 0
//    waits for it to have read the tile before the tile is written again;
//  * cudaFuncSetAttribute and the occupancy query run once per instance.
//
// Inputs may be strided views ([B, S, H, D] projections seen as
// [B, H, S, D]): the innermost dimension must be contiguous, every stride
// a multiple of 16 bytes and the base 16-byte aligned (TMA's rules; the
// Python wrapper checks them).  The C entry point returns 0, a cudaError_t
// code, or a negative code of its own (see vidtome_small_kv_attention).

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;       // query rows of a work item (one warpgroup)
constexpr int kThreads = 128;
constexpr int kStages = 2;      // Q ring depth
constexpr float kNegBig = -1e30f;

// Shared memory per instance: NA swizzle atoms of SW bytes (SW / 2 bf16
// columns) across D, KVP keys, every region 1024-byte aligned.
template <int NA, int KVP, int SW>
struct Layout {
  static constexpr int COLS = SW / 2;              // bf16 columns of an atom
  static constexpr int KSTEPS = SW / 32;           // k16 steps in an atom row
  static constexpr uint32_t Q_ATOM = kRows * SW;   // one atom of a Q / O tile
  static constexpr uint32_t KV_ATOM = KVP * SW;
  static constexpr uint32_t KV_BYTES = NA * KV_ATOM;  // K or V
  static constexpr uint32_t Q_BYTES = NA * Q_ATOM;    // a Q or O tile
  static constexpr uint32_t V_OFF = KV_BYTES;
  static constexpr uint32_t Q_OFF = 2 * KV_BYTES;               // the ring
  static constexpr uint32_t O_OFF = Q_OFF + kStages * Q_BYTES;  // staging
  static constexpr uint32_t BAR_OFF = O_OFF + Q_BYTES;
  // + kStages Q barriers and one K/V barrier, + slack to align the base
  static constexpr size_t SMEM = BAR_OFF + 8 * (kStages + 1) + 1024;
  static constexpr uint32_t SBO = 8 * SW;  // bytes between 8-row groups
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;  // descriptor swizzle
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The Q tile of work item `item` into the ring stage at `dst`, completing
// on `bar`.
template <int NA, int KVP, int SW>
__device__ __forceinline__ void load_q(const CUtensorMap* tm, uint32_t dst,
                                       uint32_t bar, int item, int tiles,
                                       int H) {
  using L = Layout<NA, KVP, SW>;
  const int bh = item / tiles;
  mbar_expect_tx(bar, L::Q_BYTES);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    tma_load(dst + a * L::Q_ATOM, tm, bar, a * L::COLS,
             (item % tiles) * kRows, bh % H, bh / H);
  }
}

// K and V of (batch, head) bh, completing on `bar`.
template <int NA, int KVP, int SW>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t sK,
                                        uint32_t bar, int bh, int H) {
  using L = Layout<NA, KVP, SW>;
  mbar_expect_tx(bar, 2 * L::KV_BYTES);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    tma_load(sK + a * L::KV_ATOM, tm_k, bar, a * L::COLS, 0, bh % H, bh / H);
    tma_load(sK + L::V_OFF + a * L::KV_ATOM, tm_v, bar, a * L::COLS, 0,
             bh % H, bh / H);
  }
}

// acc (+)= P V over one k16 step for one atom of columns: m64n32k16 (64-byte
// atoms) or m64n64k16 (128-byte atoms); acc starts at zero.
template <int N>
__device__ __forceinline__ void pv_step(float (&acc)[N], const uint32_t (&p)[4],
                                        uint64_t dv) {
  if constexpr (N == 16) {
    wgmma_rs(acc, p, dv, 1);
  } else {
    wgmma_rs(acc, p, dv);
  }
}

template <int NA, int KVP, int SW>
__global__ void __launch_bounds__(kThreads, 1)
small_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o, int H, int tiles,
                int total, int per_block, int kv_len, float scale_log2) {
  using L = Layout<NA, KVP, SW>;
  constexpr int NC = KVP / 64;          // 64-key chunks of S
  constexpr bool TAIL = KVP % 64 != 0;  // and one 16-key chunk (80 keys)
  constexpr int KS = KVP / 16;          // k16 steps of P V

  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + L::V_OFF;
  const uint32_t sQ = sK + L::Q_OFF;
  const uint32_t sO = sK + L::O_OFF;
  const uint32_t q_full = sK + L::BAR_OFF;  // + 8 s: Q stage s
  const uint32_t kv_full = q_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int first = blockIdx.x * per_block;
  const int count = min(per_block, total - first);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(q_full + 8 * s, 1);
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int cur_bh = first / tiles;
  if (tid == 0) {
    load_kv<NA, KVP, SW>(&tm_k, &tm_v, sK, kv_full, cur_bh, H);
    for (int n = 0; n < kStages && n < count; ++n) {
      load_q<NA, KVP, SW>(&tm_q, sQ + n * L::Q_BYTES, q_full + 8 * n,
                          first + n, tiles, H);
    }
  }
  uint32_t kv_phase = 0;
  mbar_wait_warp(kv_full, kv_phase);

  for (int n = 0; n < count; ++n) {
    const int item = first + n;
    const int bh = item / tiles;
    const int s = n % kStages;
    if (bh != cur_bh) {
      // Every warp is past the previous item's P V (the barrier before its
      // store), so K and V may be overwritten.
      cur_bh = bh;
      kv_phase ^= 1;
      if (tid == 0) load_kv<NA, KVP, SW>(&tm_k, &tm_v, sK, kv_full, bh, H);
      mbar_wait_warp(kv_full, kv_phase);
    }
    const uint32_t q_tile = sQ + s * L::Q_BYTES;
    mbar_wait_warp(q_full + 8 * s, (n / kStages) & 1);

    // S = Q K^T: k16 steps of 32 bytes along an atom row; a 64-key chunk of
    // K starts 64 rows into its atom.
    float sc[NC][32];
    float st[8];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[c][e] = 0.f;
      fence_regs(sc[c]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) st[e] = 0.f;
    fence_regs(st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < L::KSTEPS * NA; ++ks) {
      const uint32_t off = (ks % L::KSTEPS) * 32;
      const int a = ks / L::KSTEPS;
      const uint64_t dq =
          smem_desc(q_tile + a * L::Q_ATOM + off, 16, L::SBO, L::MODE);
      const uint32_t k_atom = sK + a * L::KV_ATOM + off;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wgmma_ss(sc[c], dq,
                 smem_desc(k_atom + c * 64 * SW, 16, L::SBO, L::MODE), ks > 0);
      }
      if (TAIL) {
        wgmma_ss(st, dq, smem_desc(k_atom + NC * 64 * SW, 16, L::SBO, L::MODE),
                 ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(sc[c]);
    fence_regs(st);

    // Every warp has read Q stage s, and the previous store has read the
    // staging tile: refill the stage with item n + kStages.
    if (tid == 0) bulk_wait_read();
    __syncthreads();
    if (tid == 0 && n + kStages < count) {
      load_q<NA, KVP, SW>(&tm_q, q_tile, q_full + 8 * s, item + kStages,
                          tiles, H);
    }

    // Softmax over the whole row, rows g and g + 8 of this warp's 16.  Keys
    // at or past kv_len were zero-filled by TMA: they score 0, so mask them.
    if (kv_len < KVP) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = 64 * c + (e / 4) * 8 + 2 * t + (e & 1);
          if (col >= kv_len) sc[c][e] = kNegBig;
        }
      }
      if (TAIL) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int col = 64 * NC + (e / 4) * 8 + 2 * t + (e & 1);
          if (col >= kv_len) st[e] = kNegBig;
        }
      }
    }
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
      }
    }
    if (TAIL) {
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], st[e]);
    }
    float m[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m[r] = mx[r] * scale_log2;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        sc[c][e] = exp2_ftz(fmaf(sc[c][e], scale_log2, -m[r]));
        l[r] += sc[c][e];
      }
    }
    if (TAIL) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e >> 1) & 1;
        st[e] = exp2_ftz(fmaf(st[e], scale_log2, -m[r]));
        l[r] += st[e];
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];  // the row max scores exp2(0) = 1: l >= 1
    }
    uint32_t pa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks / 4 < NC ? ks / 4 : NC - 1;
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) p[e] = ks < 4 * NC ? sc[c][8 * (ks % 4) + e] : st[e];
      pa[ks][0] = pack_bf16(p[0] * inv[0], p[1] * inv[0]);
      pa[ks][1] = pack_bf16(p[2] * inv[1], p[3] * inv[1]);
      pa[ks][2] = pack_bf16(p[4] * inv[0], p[5] * inv[0]);
      pa[ks][3] = pack_bf16(p[6] * inv[1], p[7] * inv[1]);
    }

    // O = P V: per k16 step (16 keys of a V atom) one instruction per atom.
    float acc[NA][L::COLS / 2];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int e = 0; e < L::COLS / 2; ++e) acc[a][e] = 0.f;
      fence_regs(acc[a]);
    }
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        pv_step(acc[a], pa[ks],
                smem_desc(sV + a * L::KV_ATOM + ks * 16 * SW, L::KV_ATOM,
                          L::SBO, L::MODE));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int a = 0; a < NA; ++a) fence_regs(acc[a]);
    fence_regs(pa);

    // O into the staging tile in the store map's swizzle: 16-byte chunk j
    // of row `row` sits at chunk j ^ (bits 7 and up of the row's offset).
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int j = 0; j < L::COLS / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          const int chunk = j ^ ((row * SW >> 7) & (SW / 16 - 1));
          const uint32_t val = pack_bf16(acc[a][4 * j + 2 * r], acc[a][4 * j + 2 * r + 1]);
          st_shared(sO + a * L::Q_ATOM + row * SW + (chunk << 4) + 4 * t, val);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        tma_store(&tm_o, sO + a * L::Q_ATOM, a * L::COLS,
                  (item % tiles) * kRows, bh % H, bh / H);
      }
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// ---- host ----

template <int NA, int KVP, int SW>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int kv_len, int D, const long long* st, float scale_log2,
           cudaStream_t stream) {
  using L = Layout<NA, KVP, SW>;
  struct Fit {
    cudaError_t err;
    int blocks;  // blocks resident on the whole card at once
  };
  static const Fit fit = [] {
    auto kern = small_kv_kernel<NA, KVP, SW>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, L::SMEM);
    }
    return Fit{err, sms * per_sm};
  }();
  if (fit.err != cudaSuccess) return (int)fit.err;
  if (fit.blocks <= 0) return -4;
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapSwizzle sw =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  int err = encode(&tq, q, D, Sq, H, B, st, kRows, L::COLS, sw);
  if (err == 0) err = encode(&tk, k, D, kv_len, H, B, st + 3, KVP, L::COLS, sw);
  if (err == 0) err = encode(&tv, v, D, kv_len, H, B, st + 6, KVP, L::COLS, sw);
  if (err == 0) err = encode(&to, o, D, Sq, H, B, st + 9, kRows, L::COLS, sw);
  if (err != 0) return err;
  const int tiles = (Sq + kRows - 1) / kRows;
  const int total = B * H * tiles;
  const int per_block = (total + fit.blocks - 1) / fit.blocks;
  const int grid = (total + per_block - 1) / per_block;
  small_kv_kernel<NA, KVP, SW><<<grid, kThreads, L::SMEM, stream>>>(
      tq, tk, tv, to, H, tiles, total, per_block, kv_len, scale_log2);
  return (int)cudaGetLastError();
}

template <int NA, int SW>
int launch_kv(int kvp, const void* q, const void* k, const void* v, void* o,
              int B, int H, int Sq, int kv_len, int D, const long long* st,
              float scale_log2, cudaStream_t s) {
  switch (kvp) {
    case 64: return launch<NA, 64, SW>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 80: return launch<NA, 80, SW>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 128: return launch<NA, 128, SW>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 256: return launch<NA, 256, SW>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    default: return -1;
  }
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s) in elements.
// kvp: the padded key count (64, 80, 128 or 256, at least kv_len); k and v
// are read up to row kv_len only.  dp (D padded to a multiple of 16) is
// not read: the kernel pads D to whole swizzle atoms itself.  Returns 0
// on success, a cudaError_t code, -1 for an unsupported D or kvp, -2 when
// the driver has no cuTensorMapEncodeTiled, -3 when it refuses a tensor
// map, -4 when no block fits on an SM.
extern "C" int vidtome_small_kv_attention(const void* q, const void* k,
                                          const void* v, void* o, int B, int H,
                                          int Sq, int kv_len, int D, int dp,
                                          int kvp, const long long* strides,
                                          float scale_log2, void* stream) {
  (void)dp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > 0 && D <= 64) {  // one 128-byte atom: one TMA box a row
    return launch_kv<1, 128>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
  }
  switch ((D + 31) / 32) {  // 64-byte atoms of 32 columns
    case 3: return launch_kv<3, 64>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 4: return launch_kv<4, 64>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 5: return launch_kv<5, 64>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    default: return -1;
  }
}
