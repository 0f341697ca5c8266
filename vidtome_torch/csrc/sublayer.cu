// Fused transformer cross-attention sublayer for Hopper (sm_90a), bf16
// activations and weights, fp32 statistics and accumulators.
//
// Replaces vidtome_tpu/ops/sublayer.py:fused_cross_sublayer
// (_sublayer_kernel).  For a tile of BM rows of one batch element:
//
//   h  = x + a1                          (attn1 residual, fp32)
//   y2 = LayerNorm(h; g2, b2)            (fp32 one-pass statistics, bf16)
//   q  = y2 Wq^T                         (scale * log2(e) folded into Wq)
//   a  = softmax_per_head(q k_h^T) v_h   (base 2, keys past kv_len masked)
//   x3 = h + a Wout^T + bout             (bf16)
//   y3 = LayerNorm(x3; g3, b3)           (of the bf16-rounded x3)
//
// and x3, y3 go to device memory: x and a1 are read (twice, the second time
// from L2), x3 and y3 written once; y2, q and a never leave the SM.  K and
// V ([B, Skv, C], the 77 projected text tokens) come from two matmuls
// outside, as the JAX package leaves them to XLA.
//
// What bounds it: the two C x C projections are 4 C^2 FLOPs per row (at
// C = 1280, 16x the attention's), so the kernel is bound by tensor-core
// issue on them and by feeding their B operand, the weights.  The TPU
// kernel keeps Wq and Wout resident in 16 MB of VMEM; a Hopper block has
// 227 KB, so here the row tile (y2, then a) and q (then x3) sit in shared
// memory and the weights stream from global memory, where both fit in the
// 50 MB L2 and stay there across blocks (3.3 MB each at C = 1280).  BM is
// chosen by C to fill shared memory: 128 rows up to C = 320, 64 up to 640,
// 32 up to 1280.
//
// Design (simple first version; no TMA, wgmma or shared-memory staging of
// the weights yet):
//  * 8 warps (the shared memory holds one block per SM, so the warps are
//    what hides latency).  Each projection walks the output columns in
//    warp-owned slabs of 16 / MF 8-column tiles (MF = BM / 16 row
//    fragments), the K loop in steps of 32: one 16-byte load of 8
//    consecutive input channels per thread feeds two mma.sync m16n8k16
//    steps for both operands (the input channels are permuted the same way
//    in A and B, which leaves the sum unchanged), so W rows are read in
//    64-byte segments straight from L2 and A from shared memory; the
//    weight fragments of the next K step are loaded while this step's
//    products run (8 warps and this prefetch: 1.4-1.6x the first 4-warp
//    version on the card);
//  * the attention slices each head's D columns (D = 40 pads to 48 with
//    zero K columns, as the flash kernel does) instead of the TPU's
//    channel-masked full-C contraction, which spends heads x the score
//    FLOPs to avoid 40-lane slices; the head's K and V are staged in shared
//    memory, each warp takes 16-row fragments, and p is normalised before
//    P V, as in the TPU kernel;
//  * LayerNorm rows are one warp each, 8 channels per lane per step.
//
// Contract of the C entry point: x, a1, x3, y3 contiguous [B, S, C]; k, v
// contiguous [B, Skv, C]; wq (pre-scaled), wout contiguous [C, C] in the
// [out, in] layout of torch.nn.Linear; bout, g2, b2, g3, b3 fp32 [C].
// C a multiple of 32, D = C / heads a multiple of 8 with DP = D rounded up
// to 16, kvp = Skv rounded up to 16 and at most 128.  Returns the CUDA
// error of the launch (0 on success), or -1 for an unsupported (DP, MF).

#include "mma_tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;          // shared-memory row padding (elements)
constexpr int kMaxKV = 128;      // padded keys a launch may carry

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  u.x = vt::pack_bf16(f[0], f[1]);
  u.y = vt::pack_bf16(f[2], f[3]);
  u.z = vt::pack_bf16(f[4], f[5]);
  u.w = vt::pack_bf16(f[6], f[7]);
  return u;
}

// Row LayerNorm of one warp's row, fp32 statistics with the one-pass
// variance max(E[v^2] - mu^2, 0).  `load(c, f)` fills f[0..8) with the row's
// channels c..c+7; `store(c, u)` takes the normalised bf16 values.
template <class Load, class Store>
__device__ __forceinline__ void layer_norm_row(int C, float eps,
                                               const float* gamma,
                                               const float* beta, Load load,
                                               Store store) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f, sq = 0.f, f[8];
  for (int c = lane * 8; c < C; c += 256) {
    load(c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sum += f[i];
      sq += f[i] * f[i];
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float mu = sum / C;
  const float inv = rsqrtf(fmaxf(sq / C - mu * mu, 0.f) + eps);
  for (int c = lane * 8; c < C; c += 256) {
    load(c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * inv * gamma[c + i] + beta[c + i];
    store(c, pack8(f));
  }
}

// out[BM, C] = A[BM, C] W^T: A in shared memory (row stride lda), W [C, C]
// row-major [out, in] in global memory.  epi(row, col, v0, v1) receives
// the fp32 results of columns col, col + 1 of a row.
template <int MF, class Epi>
__device__ __forceinline__ void tile_gemm(const __nv_bfloat16* sA, int lda,
                                          const __nv_bfloat16* __restrict__ W,
                                          int C, Epi epi) {
  constexpr int NTW = 16 / MF;   // 8-column tiles per warp slab
  constexpr int CW = NTW * 8;    // columns per warp slab
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int n0 = warp * CW; n0 < C; n0 += kWarps * CW) {
    float acc[MF][NTW][4];
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    // the weight fragments of the next k step are in flight while this
    // step's products run (the loads come from L2)
    uint4 bnext[NTW];
    auto load_b = [&](int k0) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int n = n0 + j * 8 + g;
        bnext[j] = n < C ? *reinterpret_cast<const uint4*>(W + (long long)n * C + k0 + 8 * t)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    load_b(0);
    for (int k0 = 0; k0 < C; k0 += 32) {
      uint4 bcur[NTW];
#pragma unroll
      for (int j = 0; j < NTW; ++j) bcur[j] = bnext[j];
      if (k0 + 32 < C) load_b(k0 + 32);
      uint4 alo[MF], ahi[MF];
#pragma unroll
      for (int m = 0; m < MF; ++m) {
        alo[m] = *reinterpret_cast<const uint4*>(sA + (m * 16 + g) * lda + k0 + 8 * t);
        ahi[m] = *reinterpret_cast<const uint4*>(sA + (m * 16 + g + 8) * lda + k0 + 8 * t);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const uint4 bw = bcur[j];
        const uint32_t b0[2] = {bw.x, bw.y};
        const uint32_t b1[2] = {bw.z, bw.w};
#pragma unroll
        for (int m = 0; m < MF; ++m) {
          const uint32_t a0[4] = {alo[m].x, ahi[m].x, alo[m].y, ahi[m].y};
          const uint32_t a1[4] = {alo[m].z, ahi[m].z, alo[m].w, ahi[m].w};
          vt::mma_16816(acc[m][j], a0, b0);
          vt::mma_16816(acc[m][j], a1, b1);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MF; ++m) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int col = n0 + j * 8 + t * 2;
        if (col >= C) continue;
        epi(m * 16 + g, col, acc[m][j][0], acc[m][j][1]);
        epi(m * 16 + g + 8, col, acc[m][j][2], acc[m][j][3]);
      }
    }
  }
}

template <int DP, int MF>
__global__ void __launch_bounds__(kThreads)
sublayer_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ a1,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ wq,
                const __nv_bfloat16* __restrict__ wout,
                const float* __restrict__ bout, const float* __restrict__ g2,
                const float* __restrict__ b2, const float* __restrict__ g3,
                const float* __restrict__ b3, __nv_bfloat16* __restrict__ x3,
                __nv_bfloat16* __restrict__ y3, int S, int C, int heads, int D,
                int skv, int kvp, int kv_len, float eps) {
  constexpr int BM = MF * 16;
  constexpr int LK = DP + kPad;
  constexpr int NT = kMaxKV / 8;
  constexpr int NO = DP / 8;
  const int ldc = C + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sY = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // y2, then a
  __nv_bfloat16* sQ = sY + BM * ldc;                                 // q, then x3
  __nv_bfloat16* sK = sQ + BM * ldc;
  __nv_bfloat16* sV = sK + kvp * LK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BM;
  const long long base = ((long long)b * S + row0) * C;
  const __nv_bfloat16* xb = x + base;
  const __nv_bfloat16* ab = a1 + base;

  // 1. y2 = LN2(x + a1) into sY; rows past S are zero.  q's pad columns
  //    are zeroed: the last head's padded score columns read them.
  for (int r = warp; r < BM; r += kWarps) {
    __nv_bfloat16* yr = sY + r * ldc;
    if (lane == 0) *reinterpret_cast<uint4*>(sQ + r * ldc + C) = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r >= S) {
      for (int c = lane * 8; c < C; c += 256)
        *reinterpret_cast<uint4*>(yr + c) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    layer_norm_row(
        C, eps, g2, b2,
        [&](int c, float* f) {
          float fa[8];
          unpack8(*reinterpret_cast<const uint4*>(xb + (long long)r * C + c), f);
          unpack8(*reinterpret_cast<const uint4*>(ab + (long long)r * C + c), fa);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] += fa[i];
        },
        [&](int c, uint4 u) { *reinterpret_cast<uint4*>(yr + c) = u; });
  }
  __syncthreads();

  // 2. q = y2 Wq^T into sQ (bf16).
  tile_gemm<MF>(sY, ldc, wq, C, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(sQ + r * ldc + c) = __floats2bfloat162_rn(v0, v1);
  });

  // 3. per head: a[:, hD:(h+1)D] = softmax(q_h k_h^T) v_h into sY.
  const __nv_bfloat16* kb = k + (long long)b * skv * C;
  const __nv_bfloat16* vb = v + (long long)b * skv * C;
  const int nt = kvp / 8;
  for (int hd = 0; hd < heads; ++hd) {
    __syncthreads();  // q complete / the previous head's K and V consumed
    vt::load_tile(sK, LK, kb + hd * D, C, kvp, DP, kv_len, D);
    vt::load_tile(sV, LK, vb + hd * D, C, kvp, DP, kv_len, D);
    __syncthreads();
    for (int m = warp; m < MF; m += kWarps) {
      float s[NT][4];
      vt::qk_scores<NT, DP>(s, sQ, ldc, m * 16 + g, hd * D, sK, LK, nt);
      uint32_t p[NT / 2][4];
      vt::softmax_to_fragments<NT>(s, p, nt, kv_len);
      float acc[NO][4];
      vt::pv_product<NT, NO>(acc, p, sV, LK, nt);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int col = j * 8 + t * 2;
        if (col >= D) continue;
        __nv_bfloat16* yr = sY + (m * 16 + g) * ldc + hd * D + col;
        *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(yr + 8 * ldc) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
  }
  __syncthreads();

  // 4. x3 = h + a Wout^T + bout: bf16 to device memory and into sQ.
  tile_gemm<MF>(sY, ldc, wout, C, [&](int r, int c, float v0, float v1) {
    __nv_bfloat162 out = __floats2bfloat162_rn(0.f, 0.f);
    if (row0 + r < S) {
      const long long off = (long long)r * C + c;
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xb + off));
      const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ab + off));
      out = __floats2bfloat162_rn(xv.x + av.x + v0 + bout[c], xv.y + av.y + v1 + bout[c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(x3 + base + off) = out;
    }
    *reinterpret_cast<__nv_bfloat162*>(sQ + r * ldc + c) = out;
  });
  __syncthreads();

  // 5. y3 = LN3(x3), from the bf16-rounded x3.
  for (int r = warp; r < BM && row0 + r < S; r += kWarps) {
    const __nv_bfloat16* xr = sQ + r * ldc;
    __nv_bfloat16* yout = y3 + base + (long long)r * C;
    layer_norm_row(
        C, eps, g3, b3,
        [&](int c, float* f) { unpack8(*reinterpret_cast<const uint4*>(xr + c), f); },
        [&](int c, uint4 u) { *reinterpret_cast<uint4*>(yout + c) = u; });
  }
}

template <int DP, int MF>
int launch(const void* const* p, int B, int S, int C, int heads, int skv,
           int kvp, int kv_len, float eps, size_t smem, cudaStream_t stream) {
  auto kern = sublayer_kernel<DP, MF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = const __nv_bfloat16*;
  dim3 grid((S + MF * 16 - 1) / (MF * 16), B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<bf>(p[0]), static_cast<bf>(p[1]), static_cast<bf>(p[2]),
      static_cast<bf>(p[3]), static_cast<bf>(p[4]), static_cast<bf>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<const float*>(p[8]), static_cast<const float*>(p[9]),
      static_cast<const float*>(p[10]),
      static_cast<__nv_bfloat16*>(const_cast<void*>(p[11])),
      static_cast<__nv_bfloat16*>(const_cast<void*>(p[12])), S, C, heads,
      C / heads, skv, kvp, kv_len, eps);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_mf(int mf, const void* const* p, int B, int S, int C, int heads,
              int skv, int kvp, int kv_len, float eps, size_t smem,
              cudaStream_t s) {
  switch (mf) {
    case 2: return launch<DP, 2>(p, B, S, C, heads, skv, kvp, kv_len, eps, smem, s);
    case 4: return launch<DP, 4>(p, B, S, C, heads, skv, kvp, kv_len, eps, smem, s);
    case 8: return launch<DP, 8>(p, B, S, C, heads, skv, kvp, kv_len, eps, smem, s);
    default: return -1;
  }
}

}  // namespace

// ptrs: x, a1, k, v, wq, wout, bout, g2, b2, g3, b3, x3, y3 (see above).
// mf: row fragments per block (BM = 16 mf); smem: dynamic shared bytes.
extern "C" int vidtome_fused_cross_sublayer(const void* const* ptrs, int B,
                                            int S, int C, int heads, int dp,
                                            int mf, int skv, int kvp,
                                            int kv_len, float eps,
                                            long long smem, void* stream) {
  if (kvp > kMaxKV || kvp % 16 || C % 32) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  switch (dp) {
    case 16: return launch_mf<16>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 32: return launch_mf<32>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 48: return launch_mf<48>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 64: return launch_mf<64>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 80: return launch_mf<80>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 96: return launch_mf<96>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 128: return launch_mf<128>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    case 160: return launch_mf<160>(mf, ptrs, B, S, C, heads, skv, kvp, kv_len, eps, sm, s);
    default: return -1;
  }
}
