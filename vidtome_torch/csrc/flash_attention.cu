// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces vidtome_tpu/ops/attention.py:flash_attention (_flash_kernel).
// out[b,h] = softmax(q[b,h] k[b,h]^T * scale) v[b,h] over the first
// kv_len keys, with fp32 running max / sum and deferred normalisation.
//
// Shape of the work on the main path (SD1.5 at 512x512): head dims 40, 80
// and 160 in the UNet, 512 (one head) in the VAE mid block; merged
// self-attention over 1280..6144 tokens, per-frame attention over 4096,
// and cross-attention over 77 text tokens.  At these sizes the kernel is
// bound by tensor-core issue and by the softmax's exp2 and rescale work on
// the [64 x 64] score tile, not by memory: q, k and v are read once per
// query tile and the [S, S] scores never leave the SM.
//
// Design (a first, simple version; no TMA, wgmma or pipelining yet):
//  * one block = 4 warps = 64 query rows of one (batch, head); each warp
//    owns 16 rows and loops over 64-row K/V tiles staged in shared memory;
//  * Q K^T and P V run on the tensor cores with mma.sync m16n8k16
//    (bf16 x bf16 -> fp32).  The head dim is zero-padded to a multiple of
//    16 in shared memory (D = 40 runs as 48), so no D is special;
//  * the probabilities stay in registers: the fp32 score fragment of two
//    adjacent 8-column tiles is exactly the A fragment of the P V product;
//  * keys at or past kv_len (the ragged tail and any caller padding) are
//    zero-filled in shared memory and masked to -1e30 before the softmax;
//  * the TPU kernel's ones-column row-sum trick is not used: row sums are
//    kept in registers and reduced with two warp shuffles;
//  * D = 512 (the VAE) splits the output columns over gridDim.z blocks of
//    128: each recomputes the scores, but the fp32 output accumulator
//    stays at 64 registers a thread.  Shared memory above 48 KB is dynamic
//    (cudaFuncSetAttribute before the launch).
//
// Inputs may be strided views ([B, S, H, D] projections seen as
// [B, H, S, D]); the innermost dimension must be contiguous, and every
// stride a multiple of 8 elements (16-byte loads).  The C entry point
// returns the CUDA error of the launch (0 on success); the Python wrapper
// raises on anything else.

#include "mma_tiles.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key/value rows per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kPad = 8;        // shared-memory row padding (elements)

using vt::kNegBig;
using vt::load_tile;
using vt::mma_16816;
using vt::pack_bf16;
using vt::pack_raw;

template <int DP, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int Sq, int kv_len,
                 int D, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 float scale_log2) {
  constexpr int LQ = DP + kPad;   // row stride of the Q and K tiles
  constexpr int LV = DV + kPad;   // row stride of the V tile
  constexpr int NT_S = kBK / 8;   // 8-column score tiles per warp
  constexpr int NT_O = DV / 8;    // 8-column output tiles per warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBQ * LQ;
  __nv_bfloat16* sV = sK + kBK * LQ;

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int dv0 = blockIdx.z * DV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread within the group

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh + dv0;

  load_tile(sQ, LQ, qb + q0 * q_ss, q_ss, kBQ, DP, Sq - q0, D);

  float acc_o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    acc_o[j][0] = acc_o[j][1] = acc_o[j][2] = acc_o[j][3] = 0.f;
  }
  float m_run[2] = {kNegBig, kNegBig};
  float l_run[2] = {0.f, 0.f};

  const int r0 = warp * 16 + g;  // this thread's two rows in the tile
  const int r1 = r0 + 8;

  for (int kv0 = 0; kv0 < kv_len; kv0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(sK, LQ, kb + kv0 * k_ss, k_ss, kBK, DP, kv_len - kv0, D);
    load_tile(sV, LV, vb + kv0 * v_ss, v_ss, kBK, DV, kv_len - kv0, D - dv0);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      const int c = kk + t * 2;
      a[0] = *reinterpret_cast<const uint32_t*>(sQ + r0 * LQ + c);
      a[1] = *reinterpret_cast<const uint32_t*>(sQ + r1 * LQ + c);
      a[2] = *reinterpret_cast<const uint32_t*>(sQ + r0 * LQ + c + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(sQ + r1 * LQ + c + 8);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        uint32_t bf[2];
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LQ + c;
        bf[0] = *reinterpret_cast<const uint32_t*>(kr);
        bf[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(s[j], a, bf);
      }
    }

    // Scale into log2 units, mask the tail, online softmax.
    float m_tile[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = col < kv_len ? s[j][e] * scale_log2 : kNegBig;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 1));
      m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 2));
      const float m_new = fmaxf(m_run[i], m_tile[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_run[e >> 1]);
        l_run[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      acc_o[j][0] *= alpha[0];
      acc_o[j][1] *= alpha[0];
      acc_o[j][2] *= alpha[1];
      acc_o[j][3] *= alpha[1];
    }

    // O += P V: two adjacent score tiles form one 16x16 A fragment.
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vr = sV + (ks * 16 + t * 2) * LV;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const int col = j * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_raw(vr[col], vr[LV + col]);
        bf[1] = pack_raw(vr[8 * LV + col], vr[9 * LV + col]);
        mma_16816(acc_o[j], a, bf);
      }
    }
  }

  // Full row sums live across the 4 threads of a group.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    inv[i] = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + dv0;
  const int row0 = q0 + r0;
  const int row1 = q0 + r1;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = j * 8 + t * 2;
    if (dv0 + col >= D) continue;
    if (row0 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + col) =
          __floats2bfloat162_rn(acc_o[j][0] * inv[0], acc_o[j][1] * inv[0]);
    }
    if (row1 < Sq) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_ss + col) =
          __floats2bfloat162_rn(acc_o[j][2] * inv[1], acc_o[j][3] * inv[1]);
    }
  }
}

template <int DP, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Sq, int kv_len, int D, const long long* st, float scale_log2,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)((kBQ + kBK) * (DP + kPad) + kBK * (DV + kPad));
  auto kern = flash_fwd_kernel<DP, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H, (D + DV - 1) / DV);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      Sq, kv_len, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), o (b, h, s) in elements.
// Returns 0 on success, a cudaError_t code, or -1 for an unsupported D.
extern "C" int vidtome_flash_attention(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Sq, int kv_len, int D,
                                       const long long* strides,
                                       float scale_log2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch<16, 16>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 32: return launch<32, 32>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 48: return launch<48, 48>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 64: return launch<64, 64>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 80: return launch<80, 80>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 96: return launch<96, 96>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 128: return launch<128, 128>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 160: return launch<160, 160>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    case 512: return launch<512, 128>(q, k, v, o, B, H, Sq, kv_len, D, strides, scale_log2, s);
    default: return -1;
  }
}
