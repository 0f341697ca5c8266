// GroupNorm(+SiLU) for Hopper (sm_90a): x [B, rows, C] (channels last,
// bf16 or fp32) with fp32 statistics, in one launch a norm.
//
// Replaces the Pallas GroupNorm kernels of vidtome_tpu/ops/groupnorm.py:
//  * full (group_norm_kernel<T, kFull>): full_group_norm, both phases
//    of a GroupNorm in one call;
//  * stats (kStats): group_norm_stats, the group mean and rstd [B, G];
//  * apply (kApply): the normalize of fused_group_norm, from a given mean
//    and rstd;
//  * finalize (group_norm_finalize_kernel): the reduction of the fused
//    resnet conv's per-tile channel partials [B, tiles, C] to mean and rstd
//    (the Pallas fused_resnet's GN2 statistics), in a fixed order.
// All compute what the Pallas kernels compute: fp32 sums and sums of
// squares, var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps), then
// y = silu?(x * k_c + s_c) rounded to x's type, k_c = rstd * gamma_c,
// s_c = beta_c - mean * k_c (vidtome_tpu/ops/groupnorm.py:71-101, 159-209).
//
// What bounds it on the H100: memory bandwidth.  A GroupNorm is a
// reduction and one elementwise pass, about ten operations per element
// against one read and one write of it: the least time is 2 x the slab's
// bytes over 3.35 TB/s.  Between the read and the write sits a dependency
// on every row of a group.  The design:
//  * the work unit is one (batch element, slice of whole groups), owned by
//    one thread-block cluster of 1, 2, 4 or 8 blocks: groups are
//    independent, so a frame spreads over as many clusters as it has
//    slices, and the grid needs no grid-wide barrier and no cooperative
//    launch.  The host planner (ops/groupnorm.plan) picks the slice width
//    (whole groups; rows of at least 32 bytes and a multiple of 16, at most
//    256 elements: one TMA box wide) and the cluster size per shape;
//  * each block (cluster rank k) owns rows [k * span, (k + 1) * span) of
//    its slice and loads them with 3-D TMA boxes (channels, rows, batch)
//    into a ring of `stages` slots, one mbarrier a slot, so the sums start
//    as soon as the first box lands.  Resident regime (every UNet shape):
//    the ring holds the block's whole span (stages == boxes), read from
//    device memory once and kept for the normalize.  Streaming regime
//    (slices larger than the cluster's shared memory: the VAE's 256^2 and
//    512^2 slabs): the ring is refilled as slots are consumed, and after
//    the statistics the span is read again, the boxes still in the ring
//    first (no re-read for them);
//  * 256 threads a block at most 128 registers, so an SM holds two blocks
//    where shared memory allows; the planner counts the clusters the card
//    holds at once (cudaOccupancyMaxActiveClusters: 15 of 8 blocks, not
//    16, at one block an SM) and takes the plan that moves the fewest
//    bytes through the busiest SM, so a grid rarely leaves a last wave of
//    one cluster;
//  * each thread keeps fp32 sums and sums of squares of its 8 (bf16) or 4
//    (fp32) channels over its rows; the block reduces them per channel and
//    per group in a fixed order, publishes its [groups-in-slice x 2]
//    partials in its own shared memory, and after barrier.cluster every
//    block reads all ranks' partials over DSMEM in rank order, so every
//    block forms the same statistics, the same bits on every run (no
//    atomics).  A second barrier.cluster keeps every block's partials alive
//    until all ranks have read them;
//  * the normalize reads the span from shared memory and writes y with
//    16-byte vector stores: one read and one write of device memory in the
//    resident regime;
//  * the affine is read as the module holds it (bf16 or fp32), so no cast
//    launch precedes the kernel.
//
// C entries: vidtome_group_norm (full, stats, apply) takes the planner's
// launch plan; vidtome_group_norm_clusters gives the clusters of a size
// and shared memory the card holds at once (the planner's capacity; 0: the
// launch cannot run); vidtome_group_norm_finalize reduces partials.  Each returns a negative
// value for arguments the kernel does not take, or the CUDA error (0 on
// success); the Python wrapper raises on anything but 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kFinalizeChannels = 256;  // channels a finalize block
constexpr int kUnroll = 4;              // rows a thread has in flight
constexpr int kSmemLimit = 232448;  // opt-in shared memory a block (H100)
constexpr int kMaxBox = 256;        // TMA box extent, elements / rows

enum Mode : int { kFull = 0, kStats = 1, kApply = 2 };

// 16 bytes of T <-> fp32
template <typename T> struct Pack;

template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};

template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

struct Args {
  void* y;              // [B, rows, C] (full, apply)
  const void* gamma;    // [C], bf16 or fp32
  const void* beta;     // [C]
  float* mean;          // [B, G]: written (stats), read (apply)
  float* rstd;          // [B, G]
  int rows, C, G;
  int sc;               // channels of a slice (whole groups)
  int span;             // rows a cluster rank owns
  int box_rows;         // rows of a TMA box
  int stages;           // ring slots (resident: the boxes of a span)
  int stage_bytes;      // bytes of a slot (a multiple of 128)
  float eps;
  int silu, affine_bf16;
};

// Shared memory after the ring: the per-thread sums [kThreads * N] (sums,
// then sums of squares), the published partials [2][sc], k_c [sc], s_c
// [sc], then a barrier a slot.  ops/groupnorm.smem_bytes states the same
// sum.
template <typename T>
__host__ __device__ constexpr int red_floats() {
  return kThreads * Pack<T>::N;
}

template <typename T>
int smem_bytes(int sc, int stages, int stage_bytes) {
  return stages * stage_bytes + 4 * red_floats<T>() + 16 * sc + 8 * stages;
}

__device__ __forceinline__ float affine(const void* p, int i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// One box at (channel c0, row c1, batch c2) into shared memory at `dst`,
// completing on `bar`.  Rows past the batch element's end read as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// grid (slices * cluster, B), cluster (cluster, 1, 1): block rank k of
// cluster `slice` owns rows [k * span, (k + 1) * span) of channels
// [slice * sc, (slice + 1) * sc) of batch element blockIdx.y.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
group_norm_kernel(const __grid_constant__ CUtensorMap tm, const Args a) {
  using PK = Pack<T>;
  constexpr int N = PK::N;
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int slice = blockIdx.x / cs;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int sc = a.sc;
  const int row_bytes = sc * (int)sizeof(T);
  const int V = row_bytes / 16;  // 16-byte vectors a row
  const int R = kThreads / V;    // rows the block reads at once
  const int v = tid % V;
  const int rr = tid / V;
  const bool active = rr < R;
  const int S = a.stages;
  const int gsize = a.C / a.G;
  const int sg = sc / gsize;     // groups of the slice
  const int r_lo = min(a.rows, rank * a.span);
  const int r_hi = min(a.rows, r_lo + a.span);
  const int nb = (r_hi - r_lo + a.box_rows - 1) / a.box_rows;

  float* red = reinterpret_cast<float*>(smem + S * a.stage_bytes);
  float* part = red + red_floats<T>();  // [2][sc]: this rank's partials
  float* kc = part + 2 * sc;
  float* sh = kc + sc;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sh + sc);

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(smem_u32(bars + i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // load number L (in issue order) of box `box` of the span into slot L % S
  auto issue = [&](int L, int box) {
    const uint32_t bar = smem_u32(bars + L % S);
    mbar_expect_tx(bar, (uint32_t)(a.box_rows * row_bytes));
    tma_load_3d(smem_u32(smem + (L % S) * a.stage_bytes), &tm, bar,
                slice * sc, r_lo + box * a.box_rows, b);
  };
  auto wait = [&](int L) { mbar_wait(smem_u32(bars + L % S), (L / S) & 1); };
  // rows of box `box` inside the span, and the slot's first vector
  auto valid = [&](int box) { return min(a.box_rows, r_hi - r_lo - box * a.box_rows); };
  auto at = [&](int slot) { return smem + slot * a.stage_bytes + v * 16; };

  float* gm = red;       // group mean [sg], once the sums are reduced
  float* gr = red + sc;  // group rstd [sg]
  if (MODE != kApply) {
    // ---- statistics: stream the span through the ring ----
    float s[N], q[N];
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = q[i] = 0.f;
    if (tid == 0) {
      for (int L = 0; L < min(S, nb); ++L) issue(L, L);
    }
    for (int L = 0; L < nb; ++L) {
      wait(L);
      const int n = valid(L);
      const unsigned char* src = at(L % S);
      if (active) {
        for (int r = rr; r < n; r += kUnroll * R) {
          uint4 u[kUnroll];
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            if (r + j * R < n) {
              u[j] = *reinterpret_cast<const uint4*>(src + (r + j * R) * row_bytes);
            }
          }
#pragma unroll
          for (int j = 0; j < kUnroll; ++j) {
            if (r + j * R < n) {
              float f[N];
              PK::unpack(u[j], f);
#pragma unroll
              for (int i = 0; i < N; ++i) {
                s[i] += f[i];
                q[i] += f[i] * f[i];
              }
            }
          }
        }
      }
      if (L + S < nb) {  // streaming: refill the slot once all have read it
        __syncthreads();
        if (tid == 0) issue(L + S, L + S);
      }
    }
    // per channel (sums into kc, sums of squares into sh), then per group,
    // in a fixed order
    for (int pass = 0; pass < 2; ++pass) {
      if (active) {
#pragma unroll
        for (int i = 0; i < N; ++i) red[rr * sc + v * N + i] = pass ? q[i] : s[i];
      }
      __syncthreads();
      for (int c = tid; c < sc; c += kThreads) {
        float t = 0.f;
        for (int k = 0; k < R; ++k) t += red[k * sc + c];
        (pass ? sh : kc)[c] = t;
      }
      __syncthreads();
    }
    for (int g = tid; g < sg; g += kThreads) {
      float ts = 0.f, tq = 0.f;
      for (int j = 0; j < gsize; ++j) {
        ts += kc[g * gsize + j];
        tq += sh[g * gsize + j];
      }
      part[g] = ts;
      part[sc + g] = tq;
    }
    cluster.sync();  // every rank's partials are published
    const float inv_n = 1.f / ((float)a.rows * (float)gsize);
    for (int g = tid; g < sg; g += kThreads) {
      float ts = 0.f, tq = 0.f;
      for (int k = 0; k < cs; ++k) {  // rank order: the same bits everywhere
        const float* p = cluster.map_shared_rank(part, k);
        ts += p[g];
        tq += p[sc + g];
      }
      const float mean = ts * inv_n;
      const float var = fmaxf(tq * inv_n - mean * mean, 0.f);
      gm[g] = mean;
      gr[g] = rsqrtf(var + a.eps);
    }
    cluster.sync();  // no rank leaves while another reads its partials
    if (MODE == kStats) {
      if (rank == 0) {
        for (int g = tid; g < sg; g += kThreads) {
          a.mean[b * a.G + slice * sg + g] = gm[g];
          a.rstd[b * a.G + slice * sg + g] = gr[g];
        }
      }
      return;
    }
  } else {
    for (int g = tid; g < sg; g += kThreads) {
      gm[g] = a.mean[b * a.G + slice * sg + g];
      gr[g] = a.rstd[b * a.G + slice * sg + g];
    }
    __syncthreads();
  }

  // ---- normalize: y = silu?(x * k_c + s_c) ----
  for (int c = tid; c < sc; c += kThreads) {
    const int g = c / gsize;
    const float k = gr[g] * affine(a.gamma, slice * sc + c, a.affine_bf16);
    kc[c] = k;
    sh[c] = affine(a.beta, slice * sc + c, a.affine_bf16) - gm[g] * k;
  }
  __syncthreads();
  float kk[N], ss[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    kk[i] = kc[v * N + i];
    ss[i] = sh[v * N + i];
  }
  T* yb = static_cast<T*>(a.y) + (long long)b * a.rows * a.C + slice * sc + v * N;
  // silu(t) = t / (1 + e^-t); __fdividef gives t * 0 = 0 where e^-t
  // overflows
  auto emit = [&](int slot, int box) {
    const int n = valid(box);
    const unsigned char* src = at(slot);
    T* dst = yb + (long long)(r_lo + box * a.box_rows) * a.C;
    if (!active) return;
    for (int r = rr; r < n; r += kUnroll * R) {
      uint4 u[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (r + j * R < n) {
          u[j] = *reinterpret_cast<const uint4*>(src + (r + j * R) * row_bytes);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (r + j * R < n) {
          float f[N];
          PK::unpack(u[j], f);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            float t = f[i] * kk[i] + ss[i];
            if (a.silu) t = __fdividef(t, 1.f + __expf(-t));
            f[i] = t;
          }
          *reinterpret_cast<uint4*>(dst + (long long)(r + j * R) * a.C) = PK::pack(f);
        }
      }
    }
  };
  if (MODE == kApply) {
    if (tid == 0) {
      for (int L = 0; L < min(S, nb); ++L) issue(L, L);
    }
    for (int L = 0; L < nb; ++L) {
      wait(L);
      emit(L % S, L);
      if (L + S < nb) {
        __syncthreads();
        if (tid == 0) issue(L + S, L + S);
      }
    }
    return;
  }
  // full: the boxes still in the ring first (all of them when resident),
  // then the rest of the span again, load nb + j into the slot just freed
  const int keep = min(S, nb);
  for (int p = 0; p < nb; ++p) {
    if (p < keep) {
      const int box = nb - keep + p;
      emit(box % S, box);
    } else {
      const int box = p - keep;
      wait(nb + box);
      emit((nb + box) % S, box);
    }
    if (p < nb - keep) {
      __syncthreads();
      if (tid == 0) issue(nb + p, p);
    }
  }
}

// grid (G / gpb, B): block (j, b) reduces channels [j * gpb * gsize,
// (j + 1) * gpb * gsize) over the tiles in order, then each group's
// channels in order.
__global__ void __launch_bounds__(kFinalizeChannels)
group_norm_finalize_kernel(const float* psum, const float* psq, float* mean,
                           float* rstd, int tiles, int C, int G, int gpb,
                           int count, float eps) {
  __shared__ float ch_s[kFinalizeChannels], ch_q[kFinalizeChannels];
  const int gsize = C / G;
  const int nc = gpb * gsize;
  const int c0 = blockIdx.x * nc;
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < nc; c += kFinalizeChannels) {
    float ts = 0.f, tq = 0.f;
    const long long base = (long long)b * tiles * C + c0 + c;
#pragma unroll 4
    for (int t = 0; t < tiles; ++t) {
      ts += psum[base + (long long)t * C];
      tq += psq[base + (long long)t * C];
    }
    ch_s[c] = ts;
    ch_q[c] = tq;
  }
  __syncthreads();
  const float inv_n = 1.f / ((float)count * (float)gsize);
  for (int g = threadIdx.x; g < gpb; g += kFinalizeChannels) {
    float ts = 0.f, tq = 0.f;
    for (int j = 0; j < gsize; ++j) {
      ts += ch_s[g * gsize + j];
      tq += ch_q[g * gsize + j];
    }
    const float m = ts * inv_n;
    const float var = fmaxf(tq * inv_n - m * m, 0.f);
    const int o = b * G + blockIdx.x * gpb + g;
    mean[o] = m;
    rstd[o] = rsqrtf(var + eps);
  }
}

// The plan's ints, in ops/groupnorm.Plan.ints order.
struct Plan {
  int B, rows, C, G, sc, cluster, span, box_rows, boxes, stages, stage_bytes,
      smem;
};

template <typename T>
bool plan_ok(const Plan& p) {
  const int row_bytes = p.sc * (int)sizeof(T);
  const bool cluster = p.cluster == 1 || p.cluster == 2 || p.cluster == 4 ||
                       p.cluster == 8;
  return p.B > 0 && p.rows > 0 && p.G > 0 && p.C % p.G == 0 && p.sc > 0 &&
         p.C % p.sc == 0 && p.sc % (p.C / p.G) == 0 && p.sc <= kMaxBox &&
         row_bytes % 16 == 0 && (p.C * (int)sizeof(T)) % 16 == 0 && cluster &&
         p.span > 0 && (long long)p.span * p.cluster >= p.rows &&
         p.box_rows > 0 && p.box_rows <= kMaxBox && p.boxes > 0 &&
         (long long)p.boxes * p.box_rows >= p.span && p.stages > 0 &&
         p.stages <= p.boxes && p.stage_bytes % 128 == 0 &&
         p.stage_bytes >= p.box_rows * row_bytes &&
         p.smem == smem_bytes<T>(p.sc, p.stages, p.stage_bytes) &&
         p.smem <= kSmemLimit;
}

// The TMA map of x seen as [B, rows, C]: dims (C, rows, B), innermost
// first; box (sc, box_rows, 1), no swizzle, so a box lands as box_rows rows
// of sc * sizeof(T) bytes.  Returns 0, -2 when the driver has no encoder,
// -3 when it refuses the map.
template <typename T>
int encode_slab(CUtensorMap* map, const void* x, const Plan& p) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -2;
  const cuuint64_t eb = sizeof(T);
  const cuuint64_t dims[3] = {(cuuint64_t)p.C, (cuuint64_t)p.rows,
                              (cuuint64_t)p.B};
  const cuuint64_t strides[2] = {p.C * eb, (cuuint64_t)p.rows * p.C * eb};
  const cuuint32_t box[3] = {(cuuint32_t)p.sc, (cuuint32_t)p.box_rows, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = fn(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(x), dims, strides, box, one,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <typename T, int MODE>
cudaError_t prepare() {  // once per instance: the opt-in shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_norm_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  return attr;
}

void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
               const Plan& p, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(p.C / p.sc * p.cluster, p.B, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = p.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

template <typename T, int MODE>
int launch(const void* x, const Args& a, const Plan& p, cudaStream_t stream) {
  if (!plan_ok<T>(p)) return -1;
  const cudaError_t attr = prepare<T, MODE>();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm;
  const int err = encode_slab<T>(&tm, x, p);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  configure(&cfg, &cluster, p, stream);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, group_norm_kernel<T, MODE>, tm, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int clusters(int cluster, int smem) {
  if (!(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) ||
      smem <= 0 || smem > kSmemLimit) {
    return -1;
  }
  const cudaError_t attr = prepare<T, MODE>();
  if (attr != cudaSuccess) return -(int)attr;
  Plan p{};
  p.C = p.sc = 1;
  p.B = 1;
  p.cluster = cluster;
  p.smem = smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs;
  configure(&cfg, &attrs, p, nullptr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (void*)group_norm_kernel<T, MODE>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int dispatch_mode(int mode, const void* x, const Args& a, const Plan& p,
                  cudaStream_t stream) {
  switch (mode) {
    case kFull: return launch<T, kFull>(x, a, p, stream);
    case kStats: return launch<T, kStats>(x, a, p, stream);
    case kApply: return launch<T, kApply>(x, a, p, stream);
    default: return -1;
  }
}

template <typename T>
int clusters_mode(int mode, int cluster, int smem) {
  switch (mode) {
    case kFull: return clusters<T, kFull>(cluster, smem);
    case kStats: return clusters<T, kStats>(cluster, smem);
    case kApply: return clusters<T, kApply>(cluster, smem);
    default: return -1;
  }
}

Plan read_plan(const int* ints) {
  return Plan{ints[0], ints[1], ints[2], ints[3], ints[4], ints[5],
              ints[6], ints[7], ints[8], ints[9], ints[10], ints[11]};
}

}  // namespace

// Clusters of `cluster` blocks with `smem` bytes of shared memory each
// that the card can hold at once for entry `mode` (0 full, 1 stats, 2
// apply) and x of `dtype` (0 bf16, 1 fp32): 0 means such a launch cannot
// run; negative for arguments the kernel does not take (-1) or a CUDA
// error (-code).
extern "C" int vidtome_group_norm_clusters(int mode, int dtype, int cluster,
                                           int smem) {
  return dtype == 0 ? clusters_mode<__nv_bfloat16>(mode, cluster, smem)
                    : clusters_mode<float>(mode, cluster, smem);
}

// GroupNorm entry `mode` over x [B, rows, C] (dtype 0 bf16, 1 fp32; 16-byte
// aligned) with the planner's launch plan: full writes y, stats writes
// mean and rstd [B, G] (fp32), apply writes y from them.  gamma and beta
// [C] are bf16 (affine_bf16 1) or fp32.  Returns 0 on success, a
// cudaError_t code, or a negative value for arguments the kernel does not
// take.
extern "C" int vidtome_group_norm(int mode, int dtype, const void* x, void* y,
                                  const void* gamma, const void* beta,
                                  float* mean, float* rstd, const int* plan,
                                  float eps, int silu, int affine_bf16,
                                  void* stream) {
  const Plan p = read_plan(plan);
  const Args a{y,      gamma,      beta,         mean,     rstd,
               p.rows, p.C,        p.G,          p.sc,     p.span,
               p.box_rows, p.stages, p.stage_bytes, eps,   silu,
               affine_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_mode<__nv_bfloat16>(mode, x, a, p, s)
                    : dispatch_mode<float>(mode, x, a, p, s);
}

// mean and rstd [B, G] from per-tile channel sums and sums of squares
// psum, psq [B, tiles, C] (fp32) over `count` rows; gpb groups a block
// (gpb dividing G, gpb * C / G at most 256).
extern "C" int vidtome_group_norm_finalize(const float* psum, const float* psq,
                                           float* mean, float* rstd, int B,
                                           int tiles, int C, int G, int gpb,
                                           int count, float eps,
                                           void* stream) {
  if (B <= 0 || tiles <= 0 || G <= 0 || C % G != 0 || gpb <= 0 ||
      G % gpb != 0 || gpb * (C / G) > kFinalizeChannels || count <= 0) {
    return -1;
  }
  group_norm_finalize_kernel<<<dim3(G / gpb, B), kFinalizeChannels, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      psum, psq, mean, rstd, tiles, C, G, gpb, count, eps);
  return (int)cudaGetLastError();
}
