// Warp-level bf16 tensor-core helpers shared by the CUDA sources of this
// directory (each is built into its own library; the build hashes this
// header with them).  mma.sync m16n8k16: A row-major 16x16, B column-major
// 16x8, fp32 accumulators; fragment layout per the PTX ISA (thread g = lane
// / 4 owns rows g and g + 8, thread t = lane % 4 owns columns 2t, 2t + 1
// and 2t + 8, 2t + 9).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vt {

constexpr float kNegBig = -1e30f;

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy `rows` x `cols` (cols a multiple of 8) from global memory into a
// shared tile with row stride `ld`, 16 bytes per thread and step, all
// threads of the block taking part.  Rows at or past `valid_rows` and
// columns at or past `valid_cols` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, int ld,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int rows,
                                          int cols, int valid_rows,
                                          int valid_cols) {
  const int chunks = cols / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows && c < valid_cols) {
      val = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * ld + c) = val;
  }
}

// Softmax over the keys of one warp's 16 query rows held as score
// fragments s[NT][4] (NT 8-key tiles, `nt` of them live), in log2 units:
// keys at or past kv_len are masked, rows normalised (1 / max(sum, 1e-30),
// as the TPU kernels do), and the probabilities packed in place as the bf16
// A fragments of the P V product: p[ks] is the fragment of keys
// 16 ks .. 16 ks + 15.
template <int NT>
__device__ __forceinline__ void softmax_to_fragments(float (&s)[NT][4],
                                                     uint32_t (&p)[NT / 2][4],
                                                     int nt, int kv_len) {
  const int t = (threadIdx.x % 32) & 3;
  float m[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        if (col >= kv_len) s[j][e] = kNegBig;
        m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    if (2 * ks < nt) {
      p[ks][0] = pack_bf16(s[2 * ks][0] * inv[0], s[2 * ks][1] * inv[0]);
      p[ks][1] = pack_bf16(s[2 * ks][2] * inv[1], s[2 * ks][3] * inv[1]);
      p[ks][2] = pack_bf16(s[2 * ks + 1][0] * inv[0], s[2 * ks + 1][1] * inv[0]);
      p[ks][3] = pack_bf16(s[2 * ks + 1][2] * inv[1], s[2 * ks + 1][3] * inv[1]);
    }
  }
}

// acc[NO][4] += P V for one warp's 16 rows: p from softmax_to_fragments,
// V staged [keys][ld] in shared memory (zero rows past kv_len), NO 8-column
// output tiles, `nt` live 8-key tiles (a multiple of 2).
template <int NT, int NO>
__device__ __forceinline__ void pv_product(float (&acc)[NO][4],
                                           const uint32_t (&p)[NT / 2][4],
                                           const __nv_bfloat16* sV, int ld,
                                           int nt) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    if (2 * ks < nt) {
      const __nv_bfloat16* vr = sV + (ks * 16 + t * 2) * ld;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + g;
        uint32_t b[2];
        b[0] = pack_raw(vr[col], vr[ld + col]);
        b[1] = pack_raw(vr[8 * ld + col], vr[9 * ld + col]);
        mma_16816(acc[j], p[ks], b);
      }
    }
  }
}

// s[NT][4] = Q K^T for one warp's 16 query rows (rows r0 = 16 m + g and
// r0 + 8 of sQ, head columns q_col .. q_col + DP) against `nt` 8-key tiles
// of sK ([keys][ldk], DP columns, zero past the head dim).
template <int NT, int DP>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4],
                                          const __nv_bfloat16* sQ, int ldq,
                                          int r0, int q_col,
                                          const __nv_bfloat16* sK, int ldk,
                                          int nt) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    uint32_t a[4];
    const int c = q_col + kk + t * 2;
    a[0] = lds32(sQ + r0 * ldq + c);
    a[1] = lds32(sQ + (r0 + 8) * ldq + c);
    a[2] = lds32(sQ + r0 * ldq + c + 8);
    a[3] = lds32(sQ + (r0 + 8) * ldq + c + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        uint32_t b[2];
        const __nv_bfloat16* kr = sK + (j * 8 + g) * ldk + kk + t * 2;
        b[0] = lds32(kr);
        b[1] = lds32(kr + 8);
        mma_16816(s[j], a, b);
      }
    }
  }
}

}  // namespace vt
