// Fused transformer cross-attention sublayer for Hopper (sm_90a), bf16
// activations and weights, fp32 statistics and accumulators.
//
// Replaces vidtome_tpu/ops/sublayer.py:fused_cross_sublayer
// (_sublayer_kernel).  For a tile of 64 rows of one batch element:
//
//   h  = x + a1                          (attn1 residual, fp32)
//   y2 = LayerNorm(h; g2, b2)            (fp32 one-pass statistics, bf16)
//   q  = y2 Wq^T                         (scale * log2(e) folded into Wq)
//   a  = softmax_per_head(q k_h^T) v_h   (base 2, keys past kv_len masked)
//   x3 = h + a Wout^T + bout             (bf16)
//   y3 = LayerNorm(x3; g3, b3)           (of the bf16-rounded x3)
//
// x, a1 are read twice (the second time for x3, often from L2), x3 and y3
// written once; y2, q and a never leave the card's SMs (in a cluster they
// pass through a bf16 scratch in device memory, below).  K and V ([B, Skv,
// C], the 77 projected text tokens) come from two matmuls outside, as the
// JAX package leaves them to XLA.
//
// What bounds it: at C = 320 the bytes (x, a1 in, x3, y3 out: 8 bytes a
// channel of a row against 4 (C + keys) operations of the two C x C
// projections and the attention); from C = 640 the operations.  The TPU
// kernel keeps Wq and Wout resident in VMEM; a Hopper block has 227 KB, so
// the weights stream from L2 (3.3 MB each at C = 1280) through shared
// memory, reused over a block's 64 rows: per block they are the largest
// of its reads (400 KB at C = 320), and TMA brings them from L2 faster in
// rows of 128 bytes than of 64 (flash_ab.py --kernel=tma).
//
// Design:
//  * work unit: a 64-row tile of one batch element, split by whole heads
//    over a thread-block cluster of n = 1, 2, 4 or 8 blocks: rank r owns
//    columns [r W, (r + 1) W), W = C / n = HR heads of D (at most 320
//    columns; 320 at every SD1.5 / SD2.1 / SDXL UNet width, 192 at 12
//    or 24 heads of 64 and at the SDXL refiner's 8 or 16 heads of 96).  A
//    block's shared memory and registers do not grow with C, and the grid
//    does: 48 blocks at SD2.1's mid block where one block a tile gave 24.
//    The instance is (D, HR, KCH, NCK); ops/sublayer.plan picks n by the
//    grid's waves (the C entry vidtome_sublayer_clusters counts the
//    clusters the card holds at once);
//  * block: two consumer warpgroups and one producer warpgroup, of which
//    one thread issues the TMA copies, then hands its registers over
//    (setmaxnreg: 40 a producer thread, 232 a consumer).  The consumers
//    split the rank's heads (consumer 0 takes ceil(HR / 2)): a warpgroup's
//    rows are the wgmma's 64, so they cannot split the rows, and each
//    holds its heads' q (at most 96 fp32 registers a thread: 3 heads of
//    64, 4 of 48) through the whole q projection.  Branches around wgmma
//    test the warpgroup index broadcast by a shuffle: ptxas serializes
//    every wgmma of a kernel where it cannot prove such a branch uniform
//    (C7520);
//  * LN2: x and a1 of the tile's rows and the rank's columns come by TMA
//    into the K / V buffers (free until the attention); the consumers form
//    h = x + a1 in fp32 and the row partials sum h and sum h^2; every rank
//    reads all ranks' partials over DSMEM in rank order (the same bits on
//    every rank and run) between two barrier.cluster; y2 (bf16) goes into
//    the rank's slice: W / 32 atoms of [64 rows x 32 columns] in 64-byte
//    swizzle, a wgmma A operand.  The row passes read the staged rows
//    again rather than hold them in registers, so their loops stay rolled:
//    fully unrolled, the kernel's straight-line code outgrew the
//    instruction cache and every phase of it ran slow;
//  * q projection, K-outer, on wgmma (both operands from shared memory):
//    one ring item a KCH-column chunk of C (64, or 32 where the rank's
//    columns are not whole 64-column chunks or the shared memory is
//    short), the rank's own chunks first, each run rotated by the tile's
//    index.  A is the slice where the chunk is the rank's own, else the
//    peer's chunk, read by TMA from a bf16 scratch [2, B, S, C] in device
//    memory that every rank writes its y2 slice into (then
//    fence.proxy.async.global and a cluster barrier): each peer chunk
//    costs an L2 round trip on the operation-bound rows only, and nothing
//    at n = 1.  B is the Wq rows of each consumer's heads, one TMA box
//    [heads, DP rows, KCH columns] of the view [heads, D, C] in KCH * 2-byte
//    swizzle: the rows d >= D of D = 40 are TMA's zero fill, so q's pad
//    columns are exactly zero; a stage of the ring (2 to 4 of them,
//    mbarriers full / empty) holds the A boxes and both consumers' B boxes;
//  * attention per own head, on both consumers at once: K_h and V_h by
//    TMA through the view [B, Skv, heads, D] (rows past kv_len read as
//    zeros), one or two buffers a consumer, loaded once a head; S = q_h
//    K_h^T is wgmma with q_h from registers (the accumulators packed to
//    bf16 pairs are the A fragments, hopper.cuh) in NCK 16-key slabs (NCK
//    is 5 for 77 keys, 8 up to 128); the softmax is base 2 in fp32
//    registers with the kv_len mask; p is normalised and rounded, then P
//    V_h is wgmma with P from registers and V MN-major (as
//    small_kv_attention.cu, whose shared-memory atoms these are); a_h
//    (bf16) goes into the slice, where the dead y2 was;
//  * out projection, K-outer over all of a, with the same exchange (a into
//    the scratch's second half) and Wout rows for each consumer's half of
//    the rank's columns streamed by TMA; x and a1 come again by TMA into
//    the K / V buffers meanwhile;
//  * epilogue: the out projection's accumulators go to shared memory
//    (fp32), then a row pass like LN2's: x3 = h + o + bout rounded to bf16
//    in place, its row partials reduced over DSMEM in rank order, y3 from
//    the rounded x3; x3 and y3 stored 16 bytes a thread.  The last cluster
//    barrier is relaxed: a release would wait for those stores to drain;
//  * a ragged last tile: rows past S are TMA's zeros, computed on finite
//    values and never stored.
//
// C entries: vidtome_fused_cross_sublayer launches with the planner's plan
// and tensor maps (their dims, byte strides, boxes and swizzle come from
// ops/sublayer.tensor_maps, tested on the CPU); vidtome_sublayer_clusters
// gives the clusters of an instance the card holds at once (0: the launch
// cannot run).  Each returns a negative value for arguments it does not
// take (-1), no encoder (-2), a refused tensor map (-3), or the CUDA error
// (0 on success); the Python wrapper raises on anything but 0.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;                    // rows of a tile
constexpr int kConsumers = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // + the producer warpgroup
constexpr uint32_t kAtom = kRows * 64;       // [64 rows x 32 columns] bf16
constexpr int kMaxStages = 4;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemMax = 232448;
constexpr float kNegBig = -1e30f;

// One instance: head dim D, HR heads a cluster rank, ring items of KCH
// columns of C (64: 128-byte swizzled weight rows, which TMA reads from L2
// at about twice the rate of 64-byte ones; 32 where 64 does not fit), 16
// NCK padded keys.
template <int D_, int HR_, int KCH_, int NCK_>
struct Inst {
  static constexpr int D = D_;
  static constexpr int HR = HR_;
  static constexpr int KCH = KCH_;
  static constexpr int NCK = NCK_;           // 16-key slabs of S
  static constexpr int KVP = 16 * NCK;       // padded keys
  static constexpr int DP = (D + 15) / 16 * 16;  // q's columns a head
  static constexpr int W = D * HR;               // columns a rank owns
  static constexpr int HW0 = (HR + 1) / 2;       // heads of consumer 0
  static constexpr int HW1 = HR / 2;             // ... of consumer 1
  static constexpr int NQ0 = HW0 * DP;
  static constexpr int NQ1 = HW1 * DP;
  static constexpr int NO = W / 2;               // out columns a consumer
  static constexpr int KW = W / KCH;             // ring items of own columns
  static constexpr uint64_t BMODE = KCH == 64 ? 1 : 2;  // weights' swizzle
  static constexpr uint32_t BSBO = 16 * KCH;     // 8 rows of KCH columns
  static constexpr int SW = DP <= 64 ? 128 : 64;  // K / V swizzle bytes
  static constexpr int COLS = SW / 2;            // columns of a K / V atom
  static constexpr int NA = (DP + COLS - 1) / COLS;
  static constexpr int KS = DP / 16;             // k16 steps of q K^T
  static constexpr int WROWS = NQ0 + NQ1 > 2 * NO ? NQ0 + NQ1 : 2 * NO;
  static constexpr uint64_t MODE = SW == 128 ? 1 : 2;
  static_assert(W % KCH == 0 && W <= 320 && D % 8 == 0 && DP <= 160 &&
                    (KCH == 32 || KCH == 64),
                "a rank owns whole chunks, at most 320 columns");
};

// Shared memory from the 1024-aligned base: the slice (W / 32 atoms), the
// ring, the K / V buffers (at least two slices' bytes: x and a1 are staged
// there, for LN2 and again for the epilogue), the row partials (LN2,
// LN3), the five vectors of the rank's columns in fp32, the barriers;
// ops/sublayer.layout states the same sums.  The epilogue lays the out
// projection's fp32 tile [64, W + 8] from the base over the slice and the
// ring.
struct Layout {
  uint32_t a_bytes, stage, ring, kv, kv_head, part, vec, bars, total;
};

template <class I>
__host__ __device__ Layout make_layout(int n, int stages, int nkv) {
  Layout L;
  L.a_bytes = n > 1 ? I::KCH * 128 : 0u;
  L.stage = (L.a_bytes + I::WROWS * I::KCH * 2 + 1023) / 1024 * 1024;
  L.ring = I::W * 128;
  L.kv = L.ring + stages * L.stage;
  L.kv_head = 2 * I::NA * I::KVP * I::SW;
  const uint32_t kv_bytes = (I::HW1 > 0 ? 2 : 1) * nkv * L.kv_head;
  L.part = L.kv + (kv_bytes > 2 * I::W * 128 ? kv_bytes : 2 * I::W * 128);
  L.vec = L.part + 1024;
  L.bars = L.vec + 5 * I::W * 4;
  L.total = L.bars + 8 * (2 * kMaxStages + 9) + 1024;
  return L;
}

struct Args {
  const void* vec[5];       // bout, g2, b2, g3, b3: [C], bf16 or fp32
  int vec_bf16;             // bit i: vec[i] is bf16
  __nv_bfloat16* x3;        // [B, S, C]
  __nv_bfloat16* y3;        // [B, S, C]
  __nv_bfloat16* scratch;   // [2, B, S, C]: y2, a (cluster > 1)
  int S, C, kv_len, stages, nkv;
  float eps;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The last barrier: it orders no memory (a release would wait for the
// x3 / y3 stores to drain), it only keeps each rank's partials alive
// until its peers have read them.
__device__ __forceinline__ void cluster_exit() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Makes this thread's generic-proxy writes visible to wgmma and TMA (the
// async proxy): to shared memory (the slice), and with `global` to device
// memory (the scratch that a cluster's peers read).
__device__ __forceinline__ void fence_proxy_async(bool global) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (global) asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// Channels c..c+7 of a [C] vector held as bf16 or fp32.
__device__ __forceinline__ void load_vec8(const void* p, int bf16, int c,
                                          float (&f)[8]) {
  if (bf16) {
    unpack8(*reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(p) + c), f);
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + c);
    const float4 hi = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + c + 4);
    f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
    f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
  }
}

// Byte offset in the slice of the 16-byte vector v (columns 8v..8v+7) of
// `row`: atom v / 4, 64-byte rows, 64-byte swizzle (16-byte unit u of row
// r at u ^ ((r >> 1) & 3)).
__device__ __forceinline__ uint32_t slice_off(int row, int v) {
  return (v >> 2) * kAtom + row * 64 + ((((v & 3) ^ (row >> 1)) & 3) << 4);
}

// The row pass: consumer thread tid takes rows tid / 8 and tid / 8 + 32 of
// the tile and the 16-byte vectors tid % 8 + 8 k (k < VK) of each row's W
// columns, reading x and a1 staged by TMA (stage_xa: two boxes of W / 2
// columns each, rows of W bytes, no swizzle).
template <class I>
__device__ __forceinline__ void read_h(const unsigned char* xs,
                                       const unsigned char* as, int row,
                                       int v, float (&h)[8]) {
  constexpr int HV = I::W / 16;  // vectors of half a row
  const uint32_t off = (v / HV) * (kRows * I::W) + row * I::W + (v % HV) * 16;
  float fa[8];
  unpack8(*reinterpret_cast<const uint4*>(xs + off), h);
  unpack8(*reinterpret_cast<const uint4*>(as + off), fa);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] += fa[i];
}

// Sums of the 8 threads of a row (lanes 8j..8j+7).
__device__ __forceinline__ float row_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

// Mean and rstd of a row from every rank's partials (sum, sum of squares)
// at part[2 row], read over DSMEM in rank order.
__device__ __forceinline__ float2 row_stats(cg::cluster_group& cluster,
                                            float* part, int row, int n,
                                            int C, float eps) {
  float s = 0.f, q = 0.f;
  for (int k = 0; k < n; ++k) {
    const float* p = cluster.map_shared_rank(part, k);
    s += p[2 * row];
    q += p[2 * row + 1];
  }
  const float mean = s / C;
  const float var = fmaxf(q / C - mean * mean, 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// Ring item i's KCH-column chunk of C: the rank's own chunks first, then
// the peers', each run rotated by `rot` (the tile's index), so that the
// card's blocks read different weight rows at a time.
template <class I>
__device__ __forceinline__ int chunk_of(int i, int rank, int KC, int rot) {
  if (i < I::KW) return rank * I::KW + (i + rot) % I::KW;
  return (rank * I::KW + I::KW + (i - I::KW + rot) % (KC - I::KW)) % KC;
}

// The ring's read side: stage s of the items in the producer's order.
struct Cursor {
  int s = 0;
  uint32_t phase = 0;
  __device__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

// acc (+)= the K-outer product over every KCH-column chunk of C, in the
// producer's order (the rank's own chunks first): A from the slice (own
// chunks) or the stage's A box, B the stage's box at byte `b_off`.
template <class I, int N>
__device__ __forceinline__ void project(float (&acc)[N], Cursor& cur,
                                        const Layout& L, uint32_t base,
                                        uint32_t full, uint32_t empty,
                                        int stages, int rank, int KC,
                                        int rot, uint32_t b_off, int lane) {
  int prev = 0;
  for (int i = 0; i < KC; ++i) {
    const int own = chunk_of<I>(i, rank, KC, rot) - rank * I::KW;
    mbar_wait_warp(full + 8 * cur.s, cur.phase);
    const uint32_t st = base + L.ring + cur.s * L.stage;
    // A: the chunk's KCH / 32 atoms (64-byte swizzle) in the slice or the
    // stage; B: KCH-column rows (KCH * 2-byte swizzle)
    const uint32_t a_at = own >= 0 && own < I::KW
                              ? base + own * (I::KCH / 32) * kAtom : st;
    const uint32_t b_at = st + L.a_bytes + b_off;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < I::KCH / 16; ++ks) {
      wgmma_ss(acc, smem_desc(a_at + (ks / 2) * kAtom + 32 * (ks % 2), 16, 512, 2),
               smem_desc(b_at + 32 * ks, 16, I::BSBO, I::BMODE), 1);
    }
    wgmma_commit();
    wgmma_wait_1();  // the previous chunk's products are done
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
    prev = cur.s;
    cur.next(stages);
  }
  wgmma_wait_all();
  fence_regs(acc);
  if (lane == 0) mbar_arrive(empty + 8 * prev);
}

// A consumer without heads in the q projection: waits for and releases
// every item.
__device__ __forceinline__ void pass(Cursor& cur, uint32_t full,
                                     uint32_t empty, int stages, int KC,
                                     int lane) {
  for (int i = 0; i < KC; ++i) {
    mbar_wait_warp(full + 8 * cur.s, cur.phase);
    if (lane == 0) mbar_arrive(empty + 8 * cur.s);
    cur.next(stages);
  }
}

// acc (+)= P V over one k16 step for one V atom: m64n64k16 (128-byte
// atoms) or m64n32k16 (64-byte atoms); acc starts at zero.
template <int N>
__device__ __forceinline__ void pv_step(float (&acc)[N], const uint32_t (&p)[4],
                                        uint64_t dv) {
  if constexpr (N == 16) {
    wgmma_rs(acc, p, dv, 1);
  } else {
    wgmma_rs(acc, p, dv);
  }
}

// Consumer WG's q projection and attention over its heads; a_h into the
// slice.
template <class I, int WG>
__device__ __forceinline__ void attend(Cursor& cur, const Layout& L,
                                      uint32_t base, unsigned char* sm,
                                      uint32_t full, uint32_t empty,
                                      uint32_t kv_full, uint32_t kv_empty,
                                      const Args& a, int rank, int KC,
                                      int rot) {
  constexpr int HW = WG == 0 ? I::HW0 : I::HW1;
  constexpr int NQ = HW * I::DP;
  const int tid = threadIdx.x;
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[NQ > 0 ? NQ / 2 : 1];
  if constexpr (NQ > 0) {
#pragma unroll
    for (int e = 0; e < NQ / 2; ++e) acc[e] = 0.f;
    project<I>(acc, cur, L, base, full, empty, a.stages, rank, KC, rot,
               WG ? I::NQ0 * I::KCH * 2 : 0u, lane);
  } else {
    pass(cur, full, empty, a.stages, KC, lane);
  }
  // q (bf16) as the A fragments of q_h K_h^T: head h, k16 step s
  uint32_t qf[HW > 0 ? HW : 1][I::KS][4];
#pragma unroll
  for (int h = 0; h < HW; ++h) {
#pragma unroll
    for (int s = 0; s < I::KS; ++s) {
      const int o = h * I::DP / 2 + 8 * s;
      qf[h][s][0] = pack_bf16(acc[o], acc[o + 1]);
      qf[h][s][1] = pack_bf16(acc[o + 2], acc[o + 3]);
      qf[h][s][2] = pack_bf16(acc[o + 4], acc[o + 5]);
      qf[h][s][3] = pack_bf16(acc[o + 6], acc[o + 7]);
    }
  }
  // both consumers are done reading y2 from the slice
  consumers_sync<kConsumers>();

  constexpr uint32_t kv_atom = I::KVP * I::SW;
#pragma unroll 1
  for (int j = 0; j < HW; ++j) {
    // head j's q fragments (a rolled loop keeps the code small)
    uint32_t qj[I::KS][4];
#pragma unroll
    for (int h = 0; h < HW; ++h) {
#pragma unroll
      for (int s = 0; s < I::KS; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (h == j) qj[s][e] = qf[h][s][e];
        }
      }
    }
    const int buf = j % a.nkv;
    const uint32_t use = j / a.nkv;
    const uint32_t kb = base + L.kv + (WG * a.nkv + buf) * L.kv_head;
    const uint32_t vb = kb + I::NA * kv_atom;
    mbar_wait_warp(kv_full + 8 * (2 * WG + buf), use & 1);

    // S = q_h K_h^T in 16-key slabs; slab c of k16 step s starts 16 c
    // rows into atom s / (COLS / 16)
    float sc[I::NCK][8];
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) sc[c][e] = 0.f;
      fence_regs(sc[c]);
    }
    fence_regs(qj);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
#pragma unroll
      for (int s = 0; s < I::KS; ++s) {
        const uint32_t at = kb + (s / (I::COLS / 16)) * kv_atom +
                            c * 16 * I::SW + (s % (I::COLS / 16)) * 32;
        wgmma_rs_k(sc[c], qj[s], smem_desc(at, 16, 8 * I::SW, I::MODE), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) fence_regs(sc[c]);
    fence_regs(qj);

    // softmax over the row (rows g and g + 8 of this warp's 16), base 2:
    // keys at or past kv_len (TMA's zeros, or past the slabs) masked
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = 16 * c + 8 * (e >> 2) + 2 * t + (e & 1);
        if (key >= a.kv_len) sc[c][e] = kNegBig;
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[c][e]);
      }
    }
    float l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = (e >> 1) & 1;
        sc[c][e] = exp2_ftz(sc[c][e] - mx[r]);
        l[r] += sc[c][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];  // the row max scores exp2(0) = 1: l >= 1
    }
    uint32_t pa[I::NCK][4];
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
      pa[c][0] = pack_bf16(sc[c][0] * inv[0], sc[c][1] * inv[0]);
      pa[c][1] = pack_bf16(sc[c][2] * inv[1], sc[c][3] * inv[1]);
      pa[c][2] = pack_bf16(sc[c][4] * inv[0], sc[c][5] * inv[0]);
      pa[c][3] = pack_bf16(sc[c][6] * inv[1], sc[c][7] * inv[1]);
    }

    // O = P V_h: per 16-key step one instruction per V atom
    float o[I::NA][I::COLS / 2];
#pragma unroll
    for (int at = 0; at < I::NA; ++at) {
#pragma unroll
      for (int e = 0; e < I::COLS / 2; ++e) o[at][e] = 0.f;
      fence_regs(o[at]);
    }
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < I::NCK; ++c) {
#pragma unroll
      for (int at = 0; at < I::NA; ++at) {
        pv_step(o[at], pa[c],
                smem_desc(vb + at * kv_atom + c * 16 * I::SW, kv_atom,
                          8 * I::SW, I::MODE));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int at = 0; at < I::NA; ++at) fence_regs(o[at]);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(kv_empty + 8 * (2 * WG + buf));

    // a_h (bf16) into the slice, columns [hr D, (hr + 1) D) of the rank
    const int hr = WG * I::HW0 + j;
#pragma unroll
    for (int at = 0; at < I::NA; ++at) {
#pragma unroll
      for (int jj = 0; jj < I::COLS / 8; ++jj) {
        const int col = at * I::COLS + 8 * jj + 2 * t;
        if (col < I::D) {
          const int lc = hr * I::D + col;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * warp + g + 8 * r;
            *reinterpret_cast<uint32_t*>(sm + slice_off(row, lc >> 3) +
                                         (lc & 7) * 2) =
                pack_bf16(o[at][4 * jj + 2 * r], o[at][4 * jj + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// x and a1 of the tile's rows and the rank's columns, by TMA, to `xs` and
// `as`: two boxes of [64 rows x W / 2 columns] each, unswizzled (rows
// past S read as zeros), completing on `bar`.
template <class I>
__device__ __forceinline__ void stage_xa(const CUtensorMap* const* tm,
                                         uint32_t xs, uint32_t as,
                                         uint32_t bar, int rank, int row0,
                                         int b) {
  mbar_expect_tx(bar, 2 * I::W * 128);
  for (int h = 0; h < 2; ++h) {
    const int c0 = rank * I::W + h * I::W / 2;
    tma_load(xs + h * kRows * I::W, tm[6], bar, c0, row0, 0, b);
    tma_load(as + h * kRows * I::W, tm[7], bar, c0, row0, 0, b);
  }
}

// The producer: one thread stages x and a1 for LN2, then walks the ring's
// items (the q projection's chunks, then the out projection's) and the
// consumers' K / V heads in an order that never waits on a consumer that
// waits on it, and takes its part in the five cluster barriers (A: LN2
// partials, B: y2 scratch, C: a scratch, D: LN3 partials, E: exit).
template <class I>
__device__ void produce(const CUtensorMap* const* tm, const Layout& L,
                        uint32_t base, uint32_t full, uint32_t empty,
                        uint32_t kv_full, uint32_t kv_empty, uint32_t xa,
                        const Args& a, int rank, int row0, int b, int KC,
                        int rot) {
  const int stages = a.stages;
  int item = 0;
  // item: q projection (q) or out projection chunk i of the rank's order
  auto ring_item = [&](bool q, int i) {
    const int kc = chunk_of<I>(i, rank, KC, rot);
    const bool peer = i >= I::KW;
    const int s = item % stages;
    mbar_wait(empty + 8 * s, ((item / stages) & 1) ^ 1);
    const uint32_t st = base + L.ring + s * L.stage;
    const uint32_t bar = full + 8 * s;
    constexpr uint32_t row_bytes = I::KCH * 2;  // a weight row of a chunk
    mbar_expect_tx(bar, (peer ? L.a_bytes : 0u) +
                            (q ? I::NQ0 + I::NQ1 : 2 * I::NO) * row_bytes);
    if (peer) {
      for (int j = 0; j < I::KCH / 32; ++j) {
        tma_load(st + j * kAtom, tm[5], bar, kc * I::KCH + 32 * j, row0,
                 q ? 0 : 1, b);
      }
    }
    const uint32_t w = st + L.a_bytes;
    if (q) {
      tma_load(w, tm[0], bar, kc * I::KCH, 0, rank * I::HR, 0);
      if (I::HW1 > 0) {
        tma_load(w + I::NQ0 * row_bytes, tm[1], bar, kc * I::KCH, 0,
                 rank * I::HR + I::HW0, 0);
      }
    } else {
      tma_load(w, tm[2], bar, kc * I::KCH, rank * I::W, 0, 0);
      tma_load(w + I::NO * row_bytes, tm[2], bar, kc * I::KCH,
               rank * I::W + I::NO, 0, 0);
    }
    ++item;
  };
  // consumer c's head j into its buffer j % nkv
  constexpr uint32_t kv_atom = I::KVP * I::SW;
  auto kv_load = [&](int c, int j) {
    const int buf = j % a.nkv;
    const uint32_t fb = kv_full + 8 * (2 * c + buf);
    mbar_wait(kv_empty + 8 * (2 * c + buf), ((j / a.nkv) & 1) ^ 1);
    mbar_expect_tx(fb, L.kv_head);
    const uint32_t kb = base + L.kv + (c * a.nkv + buf) * L.kv_head;
    const int head = rank * I::HR + c * I::HW0 + j;
    for (int at = 0; at < I::NA; ++at) {
      tma_load(kb + at * kv_atom, tm[3], fb, at * I::COLS, 0, head, b);
      tma_load(kb + (I::NA + at) * kv_atom, tm[4], fb, at * I::COLS, 0, head,
               b);
    }
  };
  const int pre = min(stages, I::KW);
  cluster_arrive();  // A
  stage_xa<I>(tm, base + L.kv, base + L.kv + I::W * 128, xa, rank, row0, b);
  for (int i = 0; i < pre; ++i) ring_item(true, i);
  cluster_wait();
  cluster_arrive();  // B
  for (int i = pre; i < I::KW; ++i) ring_item(true, i);
  cluster_wait();    // every rank's y2 is in the scratch, and the
                     // consumers are done with x and a1 in the K / V buffers
  for (int j = 0; j < a.nkv; ++j) {
    if (j < I::HW0) kv_load(0, j);
    if (j < I::HW1) kv_load(1, j);
  }
  for (int i = I::KW; i < KC; ++i) ring_item(true, i);
  for (int i = 0; i < pre; ++i) ring_item(false, i);
  for (int j = a.nkv; j < I::HW0; ++j) {
    kv_load(0, j);
    if (j < I::HW1) kv_load(1, j);
  }
  cluster_arrive();  // C
  for (int i = pre; i < I::KW; ++i) ring_item(false, i);
  cluster_wait();    // every rank's a is in the scratch
  for (int i = I::KW; i < KC; ++i) ring_item(false, i);
  cluster_sync();    // D
  cluster_exit();    // E
}

template <int D, int HR, int KCH, int NCK>
__global__ void __launch_bounds__(kThreads, 1)
sublayer_kernel(const __grid_constant__ CUtensorMap tm_wq0,
                const __grid_constant__ CUtensorMap tm_wq1,
                const __grid_constant__ CUtensorMap tm_wout,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_scr,
                const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_a1, const Args a) {
  using I = Inst<D, HR, KCH, NCK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);  // the aligned base
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / n) * kRows;
  const int b = blockIdx.y;
  const int S = a.S, C = a.C;
  const int col0 = rank * I::W;
  const int KC = C / I::KCH;
  const int rot = blockIdx.y * (gridDim.x / n) + blockIdx.x / n;
  const Layout L = make_layout<I>(n, a.stages, a.nkv);
  const uint32_t full = base + L.bars;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t kv_full = empty + 8 * kMaxStages;  // [consumer][buffer]
  const uint32_t kv_empty = kv_full + 8 * 4;
  const uint32_t xa = kv_empty + 8 * 4;  // x and a1 staged: LN2, epilogue
  float* part2 = reinterpret_cast<float*>(sm + L.part);  // [64][2]
  float* part3 = part2 + 2 * kRows;
  float* vec = reinterpret_cast<float*>(sm + L.vec);  // [5][W]
  const CUtensorMap* const tm[8] = {&tm_wq0, &tm_wq1, &tm_wout, &tm_k,
                                    &tm_v,   &tm_scr, &tm_x,    &tm_a1};
  const int tid = threadIdx.x;
  // the warpgroup, warp-uniform as ptxas can see (a branch it cannot prove
  // uniform around wgmma serializes every wgmma of the kernel: C7520)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
    }
    for (int i = 0; i < 4; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, 4);  // the consumer's four warps
    }
    mbar_init(xa, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      produce<I>(tm, L, base, full, empty, kv_full, kv_empty, xa, a, rank,
                 row0, b, KC, rot);
    } else {
      for (int k = 0; k < 4; ++k) cluster_sync();  // A..D
      cluster_exit();                               // E
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // ---- LN2: h = x + a1 over the rank's columns, y2 into the slice ----
  const int rr = tid >> 3;
  const int l8 = tid & 7;
  constexpr int NV = I::W / 8;
  // bout, g2, b2, g3, b3 of the rank's columns into shared memory, fp32
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    for (int v = tid; v < NV; v += kConsumers) {
      float f[8];
      load_vec8(a.vec[i], (a.vec_bf16 >> i) & 1, col0 + 8 * v, f);
      float4* d = reinterpret_cast<float4*>(vec + i * I::W + 8 * v);
      d[0] = make_float4(f[0], f[1], f[2], f[3]);
      d[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
  // x and a1 over the K / V buffers (stage_xa), once for LN2 and once for
  // the epilogue; the row passes read them from there again rather than
  // hold them, so their loops stay rolled (straight-line code this long
  // runs out of the instruction cache)
  const unsigned char* xs = sm + L.kv;
  const unsigned char* as = xs + I::W * 128;
  mbar_wait(xa, 0);
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 1
  for (int v = l8; v < NV; v += 8) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float h[8];
      read_h<I>(xs, as, rr + 32 * r, v, h);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[r] += h[i];
        s2[r] += h[i] * h[i];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float t1 = row_sum8(s1[r]);
    const float t2 = row_sum8(s2[r]);
    if (l8 == 0) {
      part2[2 * (rr + 32 * r)] = t1;
      part2[2 * (rr + 32 * r) + 1] = t2;
    }
  }
  cluster_sync();  // A: every rank's LN2 partials are published
  {
    const float2 st[2] = {row_stats(cluster, part2, rr, n, C, a.eps),
                          row_stats(cluster, part2, rr + 32, n, C, a.eps)};
#pragma unroll 1
    for (int v = l8; v < NV; v += 8) {
      const float* gm = vec + 1 * I::W + 8 * v;
      const float* bt = vec + 2 * I::W + 8 * v;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rr + 32 * r;
        float h[8], y[8];
        read_h<I>(xs, as, row, v, h);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = (h[i] - st[r].x) * st[r].y * gm[i] + bt[i];
        const uint4 u = pack8(y);
        *reinterpret_cast<uint4*>(sm + slice_off(row, v)) = u;
        if (n > 1 && row0 + row < S) {
          *reinterpret_cast<uint4*>(
              a.scratch + ((long long)b * S + row0 + row) * C + col0 + 8 * v) = u;
        }
      }
    }
  }
  fence_proxy_async(n > 1);
  cluster_sync();  // B: every rank's slice and y2 scratch are written

  // ---- q projection and attention ----
  Cursor cur;
  if (wg == 0) {
    attend<I, 0>(cur, L, base, sm, full, empty, kv_full, kv_empty, a, rank,
                 KC, rot);
  } else {
    attend<I, 1>(cur, L, base, sm, full, empty, kv_full, kv_empty, a, rank,
                 KC, rot);
  }
  consumers_sync<kConsumers>();  // a is whole in the slice, K / V are read
  // x and a1 again, for h in the epilogue, while a goes out and the out
  // projection runs
  if (tid == 0) {
    stage_xa<I>(tm, base + L.kv, base + L.kv + I::W * 128, xa, rank, row0, b);
  }
  if (n > 1) {  // a into the scratch's second half, for the peers
    const long long sc = (long long)gridDim.y * S * C;
#pragma unroll 1
    for (int v = l8; v < NV; v += 8) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rr + 32 * r;
        if (row0 + row < S) {
          *reinterpret_cast<uint4*>(
              a.scratch + sc + ((long long)b * S + row0 + row) * C + col0 + 8 * v) =
              *reinterpret_cast<const uint4*>(sm + slice_off(row, v));
        }
      }
    }
  }
  fence_proxy_async(n > 1);
  cluster_sync();  // C: every rank's a is in the scratch

  // ---- out projection: columns [wg NO, (wg + 1) NO) of the rank ----
  const int warp = (tid / 32) % 4;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[I::NO / 2];
#pragma unroll
  for (int e = 0; e < I::NO / 2; ++e) acc[e] = 0.f;
  project<I>(acc, cur, L, base, full, empty, a.stages, rank, KC, rot,
             wg * I::NO * I::KCH * 2u, lane);
  consumers_sync<kConsumers>();  // the slice and the ring are read
  // o (fp32) over the slice and the ring, rows W + 8 apart
  constexpr int LD = I::W + 8;
  float* stg = reinterpret_cast<float*>(sm);
#pragma unroll
  for (int jj = 0; jj < I::NO / 8; ++jj) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      const int col = wg * I::NO + 8 * jj + 2 * t;
      *reinterpret_cast<float2*>(stg + row * LD + col) =
          make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
  consumers_sync<kConsumers>();
  mbar_wait(xa, 1);

  // ---- x3 = h + o + bout (bf16) over o's tile, LN3 ----
  s1[0] = s1[1] = s2[0] = s2[1] = 0.f;
#pragma unroll 1
  for (int v = l8; v < NV; v += 8) {
    const float* bo = vec + 8 * v;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rr + 32 * r;
      float h[8], x[8];
      read_h<I>(xs, as, row, v, h);
      float4* o = reinterpret_cast<float4*>(stg + row * LD + 8 * v);
      const float4 o0 = o[0], o1 = o[1];
      const float of[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] = __bfloat162float(__float2bfloat16_rn(h[i] + of[i] + bo[i]));
        s1[r] += x[i];
        s2[r] += x[i] * x[i];
      }
      o[0] = make_float4(x[0], x[1], x[2], x[3]);
      o[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float t1 = row_sum8(s1[r]);
    const float t2 = row_sum8(s2[r]);
    if (l8 == 0) {
      part3[2 * (rr + 32 * r)] = t1;
      part3[2 * (rr + 32 * r) + 1] = t2;
    }
  }
  cluster_sync();  // D: every rank's LN3 partials are published
  {
    const float2 st[2] = {row_stats(cluster, part3, rr, n, C, a.eps),
                          row_stats(cluster, part3, rr + 32, n, C, a.eps)};
#pragma unroll 1
    for (int v = l8; v < NV; v += 8) {
      const float* gm = vec + 3 * I::W + 8 * v;
      const float* bt = vec + 4 * I::W + 8 * v;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rr + 32 * r;
        if (row0 + row >= S) continue;
        const float4* o = reinterpret_cast<const float4*>(stg + row * LD + 8 * v);
        const float4 o0 = o[0], o1 = o[1];
        const float x[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
        float y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = (x[i] - st[r].x) * st[r].y * gm[i] + bt[i];
        const long long off = ((long long)b * S + row0 + row) * C + col0 + 8 * v;
        *reinterpret_cast<uint4*>(a.x3 + off) = pack8(x);
        *reinterpret_cast<uint4*>(a.y3 + off) = pack8(y);
      }
    }
  }
  cluster_exit();  // E: no rank leaves while a peer reads its partials
}

// ---- host ----

// The plan's ints, in ops/sublayer.SublayerPlan.ints order.
struct Plan {
  int B, S, C, heads, D, HR, n, kvp, kv_len, stages, nkv, smem;
};

// One tensor map as ops/sublayer.tensor_maps states it: dims (innermost
// first), byte strides of dims 1..3, box, swizzle bytes (64 or 128; 0:
// none).
int encode_map(CUtensorMap* map, const void* ptr, const long long* m) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t dims[4] = {(cuuint64_t)m[0], (cuuint64_t)m[1],
                              (cuuint64_t)m[2], (cuuint64_t)m[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)m[4], (cuuint64_t)m[5],
                                 (cuuint64_t)m[6]};
  const cuuint32_t box[4] = {(cuuint32_t)m[7], (cuuint32_t)m[8],
                             (cuuint32_t)m[9], (cuuint32_t)m[10]};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  if (m[11] != 0 && m[11] != 64 && m[11] != 128) return -1;
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
      m[11] == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : m[11] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <class I>
bool plan_ok(const Plan& p) {
  const bool cluster = p.n == 1 || p.n == 2 || p.n == 4 || p.n == 8;
  if (!cluster || p.B <= 0 || p.B > 65535 || p.S <= 0 || p.C != p.n * I::W ||
      p.heads != p.n * I::HR || p.D != I::D || p.kvp != I::KVP ||
      p.kv_len <= 0 || p.kv_len > p.kvp || p.stages < 2 ||
      p.stages > kMaxStages || p.nkv < 1 || p.nkv > 2) {
    return false;
  }
  const Layout L = make_layout<I>(p.n, p.stages, p.nkv);
  return p.smem == (int)L.total && p.smem <= kSmemMax &&
         (uint32_t)(kRows * (I::W + 8) * 4) <= L.kv;
}

template <int D, int HR, int KCH, int NCK>
cudaError_t prepare() {  // once per instance: the opt-in shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      sublayer_kernel<D, HR, KCH, NCK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return attr;
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int tiles,
               int B, int n, int smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(tiles * n, B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// ptrs: x, a1, k, v, wq (scaled), wout, bout, g2, b2, g3, b3, x3, y3,
// scratch; maps: wq0, wq1, wout, k, v, scratch, x, a1 (12 numbers each).
template <int D, int HR, int KCH, int NCK>
int launch(const Plan& p, const void* const* ptrs, const long long* maps,
           int vec_bf16, float eps, cudaStream_t stream) {
  using I = Inst<D, HR, KCH, NCK>;
  if (!plan_ok<I>(p)) return -1;
  const cudaError_t attr = prepare<D, HR, KCH, NCK>();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm[8] = {};
  const int src[8] = {4, 4, 5, 2, 3, 13, 0, 1};
  for (int m = 0; m < 8; ++m) {
    if ((m == 1 && I::HW1 == 0) || (m == 5 && p.n == 1)) continue;
    const int err = encode_map(&tm[m], ptrs[src[m]], maps + 12 * m);
    if (err != 0) return err;
  }
  Args a{};
  for (int i = 0; i < 5; ++i) a.vec[i] = ptrs[6 + i];
  a.vec_bf16 = vec_bf16;
  a.x3 = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[11]));
  a.y3 = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[12]));
  a.scratch = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[13]));
  a.S = p.S;
  a.C = p.C;
  a.kv_len = p.kv_len;
  a.stages = p.stages;
  a.nkv = p.nkv;
  a.eps = eps;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  configure(&cfg, &cluster, (p.S + kRows - 1) / kRows, p.B, p.n, p.smem,
            stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sublayer_kernel<D, HR, KCH, NCK>, tm[0],
                                           tm[1], tm[2], tm[3], tm[4], tm[5],
                                           tm[6], tm[7], a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int D, int HR, int KCH, int NCK>
int clusters(int n, int smem) {
  if (!(n == 1 || n == 2 || n == 4 || n == 8) || smem <= 0 ||
      smem > kSmemMax) {
    return -1;
  }
  const cudaError_t attr = prepare<D, HR, KCH, NCK>();
  if (attr != cudaSuccess) return -(int)attr;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs;
  configure(&cfg, &attrs, 1, 1, n, smem, nullptr);
  int count = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &count, (void*)sublayer_kernel<D, HR, KCH, NCK>, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

// The instances, as ops/sublayer.INSTANCES and CHUNKS: (D, HR, KCH), each
// for 80 and 128 padded keys (NCK 5 and 8).
#define VT_SUBLAYER_INSTANCES(X)                                           \
  X(16, 4, 64) X(40, 4, 32) X(40, 8, 64) X(64, 2, 64) X(64, 3, 64)         \
  X(64, 5, 64) X(80, 2, 32) X(80, 4, 64) X(96, 2, 64) X(160, 1, 32)        \
  X(160, 2, 32)

}  // namespace

// Clusters of n blocks of instance (D, HR, kvp padded keys) with `smem`
// bytes of shared memory each that the card holds at once: 0 means such a
// launch cannot run; negative for arguments the kernel does not take (-1)
// or a CUDA error (-code).
extern "C" int vidtome_sublayer_clusters(int D, int HR, int kvp, int n,
                                         int smem) {
#define X(d, hr, kch)                                              \
  if (D == d && HR == hr && kvp == 80) return clusters<d, hr, kch, 5>(n, smem); \
  if (D == d && HR == hr && kvp == 128) return clusters<d, hr, kch, 8>(n, smem);
  VT_SUBLAYER_INSTANCES(X)
#undef X
  return -1;
}

// ptrs: x, a1 [B, S, C]; k, v [B, Skv, C]; wq (scale * log2(e) folded in),
// wout [C, C] as nn.Linear weights; bout, g2, b2, g3, b3 [C] (bf16 or fp32
// by the bits of vec_bf16); x3, y3 [B, S, C]; the scratch [2, B, S, C] (or
// null at one block a cluster); all bf16 but the vectors, contiguous,
// 16-byte aligned.  plan: ops/sublayer.SublayerPlan.ints; maps: 8 x 12
// numbers of ops/sublayer.tensor_maps.  Returns 0, a cudaError_t code, or
// a negative code (see the note at the top).
extern "C" int vidtome_fused_cross_sublayer(const void* const* ptrs,
                                            const int* plan,
                                            const long long* maps,
                                            int vec_bf16, float eps,
                                            void* stream) {
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
               plan[6], plan[7], plan[8], plan[9], plan[10], plan[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define X(d, hr, kch)                                                   \
  if (p.D == d && p.HR == hr && p.kvp == 80)                            \
    return launch<d, hr, kch, 5>(p, ptrs, maps, vec_bf16, eps, s);      \
  if (p.D == d && p.HR == hr && p.kvp == 128)                           \
    return launch<d, hr, kch, 8>(p, ptrs, maps, vec_bf16, eps, s);
  VT_SUBLAYER_INSTANCES(X)
#undef X
  return -1;
}
