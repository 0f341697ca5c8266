// Single-pass attention over a short KV (at most 256 keys) for Hopper
// (sm_90a), bf16 in / bf16 out.
//
// Replaces vidtome_tpu/ops/attention.py:small_kv_attention
// (_small_kv_kernel): out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h]
// over the first kv_len keys, with the whole KV of one (batch, head) in one
// tile, one softmax pass (no running max, no rescale), scores in base 2.
//
// Shape of the work on the main paths: cross-attention against the 77
// text tokens at every level (SD2.1: [8,5,4096x77,64] in the inversion,
// [12,5..20,...x77,64] in PnP generation; SD1.5: D = 40, 80, 160), and the
// unmerged self-attention of the 16x16 and 8x8 levels (256 and 64 keys).
// The flash kernel walks such a KV in 64-key tiles with a running max and a
// rescale per tile; here the scores of a 16-row slab against all keys fit
// in registers, so the kernel is bound by tensor-core issue on Q K^T and
// P V plus one exp2 per score, and by reading q and writing o once.
//
// Design (simple first version; no TMA, wgmma or pipelining yet):
//  * one block = 4 warps; K and V of one (batch, head) are staged once in
//    shared memory (keys padded to the next of 64/80/128/256 with zero
//    rows, head dim zero-padded to a multiple of 16) and the block walks
//    kQTiles query tiles of 64 rows, each warp owning 16 rows;
//  * Q K^T and P V on the tensor cores with mma.sync m16n8k16 (bf16 x bf16
//    -> fp32).  The scale * log2(e) multiplies the fp32 scores (the TPU
//    kernel folds it into a bf16 q: the same function, one rounding less);
//  * the fp32 scores of a row slab live in registers (KVP / 8 tiles), are
//    normalised before the P V product and packed in place into its bf16 A
//    fragments, as the TPU kernel normalises p before its dot;
//  * shared memory: (2 KVP + 64) x (DP + 8) bf16, 193,536 bytes at the
//    widest case (256 keys, D = 160: SD1.5's 16x16 self-attention), under
//    the 227 KB a block may take.
//
// Inputs may be strided views ([B, S, H, D] projections seen as
// [B, H, S, D]); the innermost dimension must be contiguous, and every
// stride a multiple of 8 elements.  The C entry point returns the CUDA
// error of the launch (0 on success), or -1 for an unsupported (DP, KVP).

#include "mma_tiles.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kBQ = 64;        // query rows per tile
constexpr int kQTiles = 4;     // query tiles per block (one K/V staging)
constexpr int kPad = 8;        // shared-memory row padding (elements)

template <int DP, int KVP>
__global__ void __launch_bounds__(kThreads)
small_kv_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int H, int Sq, int kv_len,
                int D, long long q_sb, long long q_sh, long long q_ss,
                long long k_sb, long long k_sh, long long k_ss,
                long long v_sb, long long v_sh, long long v_ss,
                long long o_sb, long long o_sh, long long o_ss,
                float scale_log2) {
  constexpr int LD = DP + kPad;
  constexpr int NT = KVP / 8;   // 8-key score tiles
  constexpr int NO = DP / 8;    // 8-column output tiles

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + KVP * LD;
  __nv_bfloat16* sQ = sV + KVP * LD;

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  vt::load_tile(sK, LD, k + b * k_sb + h * k_sh, k_ss, KVP, DP, kv_len, D);
  vt::load_tile(sV, LD, v + b * v_sb + h * v_sh, v_ss, KVP, DP, kv_len, D);
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;

  for (int qt = 0; qt < kQTiles; ++qt) {
    const int q0 = (blockIdx.x * kQTiles + qt) * kBQ;
    if (q0 >= Sq) break;
    __syncthreads();  // K/V staged; the previous Q tile consumed
    vt::load_tile(sQ, LD, qb + q0 * q_ss, q_ss, kBQ, DP, Sq - q0, D);
    __syncthreads();

    const int r0 = warp * 16 + g;
    float s[NT][4];
    vt::qk_scores<NT, DP>(s, sQ, LD, r0, 0, sK, LD, NT);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }
    uint32_t p[NT / 2][4];
    vt::softmax_to_fragments<NT>(s, p, NT, kv_len);
    float acc[NO][4];
    vt::pv_product<NT, NO>(acc, p, sV, LD, NT);

    const int row0 = q0 + r0;
    const int row1 = row0 + 8;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + t * 2;
      if (col >= D) continue;
      if (row0 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + col) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
      }
      if (row1 < Sq) {
        *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_ss + col) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
    }
  }
}

template <int DP, int KVP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int kv_len, int D, const long long* st, float scale_log2,
           cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(2 * KVP + kBQ) * (DP + kPad);
  auto kern = small_kv_kernel<DP, KVP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ * kQTiles - 1) / (kBQ * kQTiles), B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Sq, kv_len, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_kv(int kvp, const void* q, const void* k, const void* v, void* o,
              int B, int H, int Sq, int kv_len, int D, const long long* st,
              float scale_log2, cudaStream_t s) {
  switch (kvp) {
    case 64: return launch<DP, 64>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 80: return launch<DP, 80>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 128: return launch<DP, 128>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    case 256: return launch<DP, 256>(q, k, v, o, B, H, Sq, kv_len, D, st, scale_log2, s);
    default: return -1;
  }
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s) in elements.
// dp: the head dim padded to a multiple of 16; kvp: the padded key count.
extern "C" int vidtome_small_kv_attention(const void* q, const void* k,
                                          const void* v, void* o, int B, int H,
                                          int Sq, int kv_len, int D, int dp,
                                          int kvp, const long long* strides,
                                          float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch_kv<16>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 32: return launch_kv<32>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 48: return launch_kv<48>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 64: return launch_kv<64>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 80: return launch_kv<80>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 96: return launch_kv<96>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 128: return launch_kv<128>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 160: return launch_kv<160>(kvp, q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    default: return -1;
  }
}
