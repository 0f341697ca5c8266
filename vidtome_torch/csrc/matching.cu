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
// matches the locally merged chunk against the bank at the same widths.
// The plain version writes and re-reads the fp32 score matrix (400 MB at
// level 0); this kernel is bound by tensor-core issue and by re-reading
// dst from L2 once per 64-row src tile.
//
// Design (a first, simple version; no TMA, wgmma or pipelining yet):
//  * one block = 4 warps = 64 src rows of one batch element; the whole
//    src tile (all channels, zero-padded to a multiple of 16) stays in
//    shared memory;
//  * dst streams through shared memory in [64 rows x 64 channels] chunks;
//    each warp accumulates its [16 x 64] score tile over the channel
//    chunks with mma.sync m16n8k16 (bf16 x bf16 -> fp32);
//  * each thread keeps a running (max, argmax) for its two rows, scanning
//    its columns in increasing order with a strict '>', so it holds the
//    lowest index among exact ties; the four threads that share a row
//    combine with "greater, or equal and lower index" -- ties go to the
//    lowest dst index, as jnp.argmax and the TPU kernel do;
//  * dst columns at or past D are skipped (the ragged last tile).
//
// src and dst must be contiguous with C a multiple of 8 (16-byte loads)
// and C <= 1728 (the src tile in shared memory).  The C entry point
// returns the CUDA error of the launch (0 on success), or -1 for an
// unsupported C; the Python wrapper raises on anything but 0.

#include "mma_tiles.cuh"

namespace {

constexpr int kBS = 64;        // src rows per block (4 warps x 16)
constexpr int kBD = 64;        // dst rows per tile
constexpr int kBK = 64;        // channels per dst chunk
constexpr int kThreads = 128;
constexpr int kPad = 8;        // shared-memory row padding (elements)
constexpr int kMaxC = 1728;

using vt::mma_16816;

__global__ void __launch_bounds__(kThreads)
best_match_kernel(const __nv_bfloat16* __restrict__ src,
                  const __nv_bfloat16* __restrict__ dst,
                  float* __restrict__ out_max, long long* __restrict__ out_idx,
                  int S, int D, int C, int CP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LS = CP + kPad;            // row stride of the src tile
  constexpr int LD = kBK + kPad;       // row stride of the dst chunk
  __nv_bfloat16* sS = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sD = sS + kBS * LS;

  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kBS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* srcb = src + (long long)b * S * C;
  const __nv_bfloat16* dstb = dst + (long long)b * D * C;

  const int chunks = CP / 8;
  for (int i = threadIdx.x; i < kBS * chunks; i += kThreads) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s0 + r < S && c < C) {
      val = *reinterpret_cast<const uint4*>(srcb + (long long)(s0 + r) * C + c);
    }
    *reinterpret_cast<uint4*>(sS + r * LS + c) = val;
  }

  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {0, 0};

  for (int d0 = 0; d0 < D; d0 += kBD) {
    float acc[kBD / 8][4];
#pragma unroll
    for (int j = 0; j < kBD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    for (int k0 = 0; k0 < CP; k0 += kBK) {
      __syncthreads();  // previous chunk consumed (first pass: src tile loaded)
      for (int i = threadIdx.x; i < kBD * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8);
        const int c = (i % (kBK / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (d0 + r < D && k0 + c < C) {
          val = *reinterpret_cast<const uint4*>(dstb + (long long)(d0 + r) * C + k0 + c);
        }
        *reinterpret_cast<uint4*>(sD + r * LD + c) = val;
      }
      __syncthreads();
      const int kend = min(kBK, CP - k0);  // a multiple of 16
      for (int kk = 0; kk < kend; kk += 16) {
        uint32_t a[4];
        const int c = k0 + kk + t * 2;
        a[0] = *reinterpret_cast<const uint32_t*>(sS + r0 * LS + c);
        a[1] = *reinterpret_cast<const uint32_t*>(sS + r1 * LS + c);
        a[2] = *reinterpret_cast<const uint32_t*>(sS + r0 * LS + c + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(sS + r1 * LS + c + 8);
#pragma unroll
        for (int j = 0; j < kBD / 8; ++j) {
          uint32_t bf[2];
          const __nv_bfloat16* dr = sD + (j * 8 + g) * LD + kk + t * 2;
          bf[0] = *reinterpret_cast<const uint32_t*>(dr);
          bf[1] = *reinterpret_cast<const uint32_t*>(dr + 8);
          mma_16816(acc[j], a, bf);
        }
      }
    }

    // running max / argmax, columns in increasing order, strict '>'
#pragma unroll
    for (int j = 0; j < kBD / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = d0 + j * 8 + t * 2 + (e & 1);
        const int i = e >> 1;
        if (col < D && acc[j][e] > best[i]) {
          best[i] = acc[j][e];
          bidx[i] = col;
        }
      }
    }
  }

  // combine the four threads of a row: greater, or equal and lower index
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (ov > best[i] || (ov == best[i] && oi < bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
  }
  if (t == 0) {
    const int rows[2] = {s0 + r0, s0 + r1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < S) {
        out_max[(long long)b * S + rows[i]] = best[i];
        out_idx[(long long)b * S + rows[i]] = bidx[i];
      }
    }
  }
}

}  // namespace

// src [B, S, C], dst [B, D, C] bf16 contiguous -> out_max [B, S] fp32,
// out_idx [B, S] int64.  Returns 0 on success, a cudaError_t code, or -1
// for an unsupported C.
extern "C" int vidtome_best_match(const void* src, const void* dst,
                                  void* out_max, void* out_idx, int B, int S,
                                  int D, int C, void* stream) {
  if (C % 8 != 0 || C <= 0 || C > kMaxC || S <= 0 || D <= 0) return -1;
  const int CP = (C + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                      (size_t)(kBS * (CP + kPad) + kBD * (kBK + kPad));
  cudaError_t err = cudaFuncSetAttribute(
      best_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBS - 1) / kBS, B);
  best_match_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(dst),
      static_cast<float*>(out_max), static_cast<long long*>(out_idx), S, D, C, CP);
  return (int)cudaGetLastError();
}
