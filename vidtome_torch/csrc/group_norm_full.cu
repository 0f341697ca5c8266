// Single-launch GroupNorm(+SiLU) for Hopper (sm_90a): x [B, rows, C]
// (channels last, bf16 or fp32) -> y of the same shape and type, with fp32
// statistics.
//
// Replaces vidtome_tpu/ops/groupnorm.py:full_group_norm, the Pallas kernel
// that runs both phases of a GroupNorm in one call (phase 0 sums every
// row's channels, phase 1 re-reads the rows and writes the normalized
// values).
//
// What bounds it on the H100: memory bandwidth.  The work is about ten
// operations per element against two reads and one write of it, so the
// least time is 3 x the slab's bytes over 3.35 TB/s (the slab is usually
// too large for the 50 MB L2 to serve the second read); the largest on the
// main path is the VAE decoder's [8, 512*512, 128] bf16, 512 MiB.  Between
// the two reads sits a dependency on every row of the batch element, which
// a kernel of independent blocks cannot wait for.  The design:
//  * a persistent cooperative grid: as many blocks as the card holds at
//    once (the occupancy calculator times the SM count), launched with
//    cudaLaunchCooperativeKernel so that every block is resident, and one
//    grid-wide barrier (cooperative_groups::this_grid().sync()) between the
//    statistics and the normalize.  A thread-block cluster would give the
//    barrier only among its 8 (16 non-portable) blocks, so a batch element
//    could use at most 16 SMs and the CFG-skip batch of 4 would leave most
//    of the 132 idle; the grid barrier lets every SM stream every batch;
//  * block (b, p) owns a contiguous span of batch element b's rows (P spans
//    per element, P chosen by the wrapper so that each block streams at
//    least ~32K elements); its threads read whole rows as 16-byte vectors
//    (C / 8 bf16 vectors a row, kThreads / (C / 8) rows at a time), four
//    rows in flight a thread, and keep per-channel fp32 sums and sums of
//    squares in registers;
//  * the block reduces its threads' sums in shared memory in a fixed order
//    and writes one [C] partial per (b, p) to global scratch; after the
//    barrier every block reduces the P partials of its element in a fixed
//    order (no atomics: the result is the same run to run), forms the group
//    mean and rsqrt(max(E[x^2] - mean^2, 0) + eps) as flax does, and folds
//    the affine into y = x * k_c + s_c (vidtome_tpu/ops/groupnorm.py:186-197);
//  * the block then re-reads its own rows (the span it summed, so for slabs
//    that fit in L2 the second read is mostly an L2 hit) and writes
//    silu?(x * k + s) rounded to the input type.
// No TMA or shared-memory staging of the rows: each element is used once
// per phase, so registers suffice.
//
// C entry points: vidtome_group_norm_full_capacity gives the number of
// blocks the grid may have; vidtome_group_norm_full launches.  Both return
// a negative value for arguments the kernel does not take; the launch
// returns the CUDA error (0 on success), and the Python wrapper raises on
// anything but 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

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
  const void* x;       // [B, rows, C]
  void* y;             // [B, rows, C]
  const float* gamma;  // [C]
  const float* beta;   // [C]
  float* psum;         // [B, P, C] scratch: per-span channel sums
  float* psq;          // [B, P, C] scratch: ... of squares
  int rows, C, G, P;
  float eps;
  int silu;
};

// shared memory: the block's reduction area [2][RPB][C] (reused for the
// element's channel sums [2][C]), then k [C], s [C], group mean / rstd [2][G]
template <typename T>
size_t smem_bytes(int C, int G) {
  const int rpb = kThreads / (C / Pack<T>::N);
  return sizeof(float) * ((size_t)2 * rpb * C + 2 * (size_t)C + 2 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) group_norm_full_kernel(Args a) {
  using PK = Pack<T>;
  constexpr int N = PK::N;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C;
  const int CV = C / N;            // 16-byte vectors a row
  const int RPB = kThreads / CV;   // rows a block reads at once
  const int b = blockIdx.x / a.P;
  const int p = blockIdx.x % a.P;
  const int span = (a.rows + a.P - 1) / a.P;
  const int r0 = min(a.rows, p * span);
  const int r1 = min(a.rows, r0 + span);
  const int v = threadIdx.x % CV;
  const int rr = threadIdx.x / CV;
  const bool active = rr < RPB;
  const long long base = (long long)b * a.rows * C + (long long)v * N;
  const uint4* xv = static_cast<const uint4*>(a.x);

  // phase 1: per-channel sums of this block's rows
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = q[i] = 0.f;
  if (active) {
    int r = r0 + rr;
    for (; r + 3 * RPB < r1; r += 4 * RPB) {
      uint4 u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = __ldg(xv + (base + (long long)(r + k * RPB) * C) / N);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float f[N];
        PK::unpack(u[k], f);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] += f[i];
          q[i] += f[i] * f[i];
        }
      }
    }
    for (; r < r1; r += RPB) {
      float f[N];
      PK::unpack(__ldg(xv + (base + (long long)r * C) / N), f);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += f[i];
        q[i] += f[i] * f[i];
      }
    }
  }
  float* red = smem;  // [2][RPB][C]
  if (active) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      red[rr * C + v * N + i] = s[i];
      red[(RPB + rr) * C + v * N + i] = q[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < RPB; ++k) {
      ts += red[k * C + c];
      tq += red[(RPB + k) * C + c];
    }
    const long long o = ((long long)b * a.P + p) * C + c;
    a.psum[o] = ts;
    a.psq[o] = tq;
  }

  cg::this_grid().sync();  // every block's partials are written

  // phase 2: the element's statistics, folded with the affine
  float* chs = smem;  // [C] (the reduction area is free again)
  float* chq = smem + C;
  float* kc = smem + 2 * RPB * C;
  float* sc = kc + C;
  float* gmean = sc + C;
  float* grstd = gmean + a.G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int j = 0; j < a.P; ++j) {  // fixed order; L2 reads (written above)
      const long long o = ((long long)b * a.P + j) * C + c;
      ts += __ldcg(a.psum + o);
      tq += __ldcg(a.psq + o);
    }
    chs[c] = ts;
    chq[c] = tq;
  }
  __syncthreads();
  const int gsize = C / a.G;
  const float inv_n = 1.f / ((float)a.rows * (float)gsize);
  for (int g = threadIdx.x; g < a.G; g += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int j = 0; j < gsize; ++j) {
      ts += chs[g * gsize + j];
      tq += chq[g * gsize + j];
    }
    const float mean = ts * inv_n;
    const float var = fmaxf(tq * inv_n - mean * mean, 0.f);
    gmean[g] = mean;
    grstd[g] = rsqrtf(var + a.eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / gsize;
    const float k = grstd[g] * a.gamma[c];
    kc[c] = k;
    sc[c] = a.beta[c] - gmean[g] * k;
  }
  __syncthreads();

  // phase 3: normalize this block's rows again
  if (!active) return;
  float kk[N], ss[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    kk[i] = kc[v * N + i];
    ss[i] = sc[v * N + i];
  }
  uint4* yv = static_cast<uint4*>(a.y);
  for (int r = r0 + rr; r < r1; r += RPB) {
    const long long at = (base + (long long)r * C) / N;
    float f[N];
    PK::unpack(__ldg(xv + at), f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float t = f[i] * kk[i] + ss[i];
      if (a.silu) t = t / (1.f + __expf(-t));
      f[i] = t;
    }
    yv[at] = PK::pack(f);
  }
}

template <typename T>
int capacity(int C, int G) {
  if (C <= 0 || G <= 0 || C % Pack<T>::N != 0 || C % G != 0 ||
      C / Pack<T>::N > kThreads) {
    return -1;
  }
  const size_t smem = smem_bytes<T>(C, G);
  auto kern = group_norm_full_kernel<T>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return -2;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem) != cudaSuccess) {
    return -2;
  }
  return per_sm * sms;
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int cap = capacity<T>(a.C, a.G);
  if (cap < 0) return cap;
  if (B <= 0 || a.rows <= 0 || a.P <= 0 || B * a.P > cap) return -1;
  Args args = a;
  void* params[] = {&args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)group_norm_full_kernel<T>, dim3(B * a.P), dim3(kThreads),
      params, smem_bytes<T>(a.C, a.G), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The number of blocks the cooperative grid may have for C channels in G
// groups (dtype 0: bf16, 1: fp32), or a negative value for a shape the
// kernel does not take (C a multiple of 8 (bf16) / 4 (fp32), at most 4096
// (bf16) / 2048 (fp32) channels, G dividing C).
extern "C" int vidtome_group_norm_full_capacity(int C, int G, int dtype) {
  return dtype == 0 ? capacity<__nv_bfloat16>(C, G) : capacity<float>(C, G);
}

// GroupNorm(+SiLU) of x [B, rows, C] into y in one cooperative launch of
// B * P blocks (P spans of rows per batch element; B * P at most the
// capacity above).  psum / psq are fp32 scratch of B * P * C each.
// Returns 0 on success, a cudaError_t code, or a negative value for
// arguments the kernel does not take.
extern "C" int vidtome_group_norm_full(const void* x, void* y,
                                       const float* gamma, const float* beta,
                                       float* psum, float* psq, int B,
                                       int rows, int C, int G, int P,
                                       float eps, int silu, int dtype,
                                       void* stream) {
  const Args a{x, y, gamma, beta, psum, psq, rows, C, G, P, eps, silu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<__nv_bfloat16>(a, B, s) : launch<float>(a, B, s);
}
