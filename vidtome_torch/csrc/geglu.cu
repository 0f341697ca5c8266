// GEGLU's gate for Hopper (sm_90a): out = h * gelu(gate), where y = [h |
// gate] is the [rows, 2 * inner] output of the feed-forward's first
// projection and gelu is the exact (erf) form.
//
// Replaces no Pallas kernel: on the TPU, XLA fused the split, the gelu and
// the product into the projection's consumers.  Eager PyTorch runs it as
// two passes over strided halves, gelu(gate) into an [rows, inner]
// intermediate and then h * that, 10 bytes an element in bf16 where 6 are
// needed.  The work is a few dozen instructions an element against 6 bytes
// (12 in fp32), far below the card's 295 operations a byte, so bytes bound
// it: at 3.35 TB/s a level-0 GEGLU of SD1.5's batched call (56 x 4096 rows,
// inner 1280) takes at least 0.53 ms.
//
// Design: one pass, each byte of y read once and each byte of out written
// once.
//  * A thread loads 16 bytes of h and the 16 bytes of gate `inner` further
//    along the same row (8 bf16 or 4 fp32 each) and stores 16 bytes; the
//    threads of a warp cover consecutive 16-byte columns of a row, so every
//    access is a whole, coalesced 512-byte run.
//  * Each thread takes kRows rows, all loads issued before the first
//    product: 4 x 32 bytes in flight a thread, about 240 KB an SM at full
//    occupancy, far above the ~15 KB an SM needs to cover HBM's latency.
//    The loads are marked evict-first (ld.global.cs): y is read once.
//  * A 2-D grid, row groups on x and column blocks on y, with a 2-D block
//    of (threads_x columns, threads_y rows): every index is a product, no
//    element pays an integer division.  ops/geglu.thread_shape picks the
//    threads a row so that few columns idle at every width (inner / 8 = 160
//    at SD1.5's level 0 is one block row of 160 threads).
//  * Where inner * sizeof(T) is not a multiple of 16 (tiny test widths, an
//    odd tensor-parallel share), rows are not 16-byte aligned: the same
//    kernel runs one element a thread (VEC = 1).
//  * Arithmetic as PyTorch's CUDA kernels: gelu in fp32 as
//    ActivationGeluKernel.cu's x * 0.5f * (1.f + erff(x * M_SQRT1_2)),
//    rounded to T, then the product of h and that in fp32, rounded to T.
//    No fast-math: the output equals h * F.gelu(gate) to the bit.
//
// y is contiguous [rows, 2 * inner], bf16 or fp32, with a 16-byte aligned
// base; out is contiguous [rows, inner] (the Python wrapper checks both and
// allocates out).  The C entry returns 0, a cudaError_t code, or -1 for
// arguments it does not take; the wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kRows = 4;           // rows a thread (ops/geglu._ROWS)
constexpr int kMaxThreads = 512;   // a block (ops/geglu._MAX_THREADS)

// float(M_SQRT1_2), as ActivationGeluKernel.cu's kAlpha
constexpr float kAlpha = 0.70710678118654752440f;

__device__ __forceinline__ float gelu(float x) {
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// h * gelu(gate) with the eager path's two roundings
template <typename T>
__device__ __forceinline__ T gate_one(T h, T g) {
  const T act = from_float<T>(gelu(to_float(g)));
  return from_float<T>(to_float(h) * to_float(act));
}

// VEC elements of T moved as one access: 16 bytes, or one element
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_once(const T* p) {
  Pack<T, VEC> out;
  static_assert(sizeof(out) == 16 || VEC == 1, "16 bytes or one element");
  if constexpr (sizeof(out) == 16) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    memcpy(&out, &raw, 16);
  } else if constexpr (sizeof(T) == 4) {
    const unsigned int raw = __ldcs(reinterpret_cast<const unsigned int*>(p));
    memcpy(&out, &raw, 4);
  } else {
    const unsigned short raw =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
    memcpy(&out, &raw, 2);
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  if constexpr (sizeof(v) == 16) {
    uint4 raw;
    memcpy(&raw, &v, 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *p = v.v[0];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    geglu_kernel(const T* __restrict__ y, T* __restrict__ out, long long rows,
                 int inner) {
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (col >= inner) return;  // the last column block's spare threads
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.y * kRows + threadIdx.y;
  Pack<T, VEC> h[kRows], g[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long r = first + static_cast<long long>(k) * blockDim.y;
    if (r < rows) {
      const T* src = y + r * 2 * inner + col;
      h[k] = load_once<T, VEC>(src);
      g[k] = load_once<T, VEC>(src + inner);
    }
  }
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long r = first + static_cast<long long>(k) * blockDim.y;
    if (r < rows) {
      Pack<T, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = gate_one(h[k].v[e], g[k].v[e]);
      store<T, VEC>(out + r * inner + col, o);
    }
  }
}

template <typename T, int VEC>
int launch(const void* y, void* out, long long rows, int inner, dim3 grid,
           dim3 block, cudaStream_t stream) {
  geglu_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<T*>(out), rows, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [rows, 2 * inner] -> out [rows, inner] on `stream`.  fp32: the dtype
// (0 bf16, 1 fp32); vec: elements an access (16 bytes' worth, or 1);
// threads_x x threads_y threads a block, threads_x a whole number of warps
// of accesses along a row, col_blocks blocks across a row.
extern "C" int vidtome_geglu(const void* y, void* out, long long rows,
                             int inner, int fp32, int vec, int threads_x,
                             int threads_y, int col_blocks, void* stream) {
  const int esize = fp32 ? 4 : 2;
  const bool vector = vec == 16 / esize;
  if (rows <= 0 || inner <= 0 || (!vector && vec != 1) || inner % vec != 0 ||
      threads_x <= 0 || threads_x % 32 != 0 || threads_y <= 0 ||
      threads_x * threads_y > kMaxThreads || col_blocks <= 0 ||
      col_blocks > 65535 ||
      static_cast<long long>(col_blocks) * threads_x * vec < inner ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return -1;
  }
  const long long per_block = static_cast<long long>(threads_y) * kRows;
  const long long row_blocks = (rows + per_block - 1) / per_block;
  if (row_blocks > INT_MAX) return -1;
  const dim3 grid(static_cast<unsigned>(row_blocks), col_blocks);
  const dim3 block(threads_x, threads_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    return vector ? launch<float, 4>(y, out, rows, inner, grid, block, s)
                  : launch<float, 1>(y, out, rows, inner, grid, block, s);
  }
  return vector ? launch<__nv_bfloat16, 8>(y, out, rows, inner, grid, block, s)
                : launch<__nv_bfloat16, 1>(y, out, rows, inner, grid, block, s);
}
