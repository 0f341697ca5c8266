// The two 3x3 convolutions of a fused ResnetBlock2D for Hopper (sm_90a),
// bf16 activations in and out, W8A8: int8 weights and activations, int32
// accumulation.  The template below also has a bf16-weight instance, which
// the port no longer builds: the bf16 block runs csrc/resnet_bf16.cu
// (TMA and wgmma).
//
// Replaces the convolution work of vidtome_tpu/ops/resnet.py:fused_resnet
// (_kernel_a: GN1 normalize+SiLU -> conv1 -> +b1+temb -> GN2 statistics;
// _kernel_b: GN2 normalize+SiLU -> conv2 -> +b2 +shortcut), with quant=False
// and quant=True.  The block in full, as ops/resnet.py drives it:
//   1. GN1 statistics of x: the port's GroupNorm statistics passes;
//   2. conv3x3 (this file) with the GN1 normalize+SiLU applied as the
//      input tile is loaded, +b1+tvec in the epilogue, h stored bf16, and
//      per-tile fp32 channel sums / sums of squares of h *before* rounding
//      written for GN2 (as _kernel_a:166-171 takes them);
//   3. GN2 statistics: a second pass reduces those per-tile partials in a
//      fixed order (no atomics: results repeat run to run);
//   4. conv3x3 (this file) again with the GN2 normalize+SiLU prologue and
//      an epilogue of +b2 +shortcut, writing the block output.
//
// Why not the TPU kernel's structure: it keeps a whole frame's fp32
// accumulator [H*W, Cout] in VMEM (6.3 MB at level 0); an SM has 227 KB.
// Here a block owns a [128 pixel x 64 channel] output tile, so the GN2
// statistics need the cross-block reduction of step 3.
//
// What bounds it on the H100: tensor-core issue (the convolutions are
// 2*H*W*9*Cin*Cout operations per image, 60 G at [8,64,64,320]) and the
// per-element normalize+SiLU of the input.  The design:
//  * implicit GEMM: M = pixels of a TH x TW tile of one image (TH*TW =
//    128), N = 64 output channels, K = 9 taps x Cin;
//  * per 64-channel chunk, the (TH+2) x (TW+2) halo of the input tile is
//    loaded once, normalized, activated and rounded to bf16 in shared
//    memory (W8A8: then multiplied by 1/sx, rounded half to even and
//    clamped to +-127 into int8, as _act_q:115-129 does); the nine taps
//    then read shifted windows of it, so each input element is activated
//    once per output-channel tile, not nine times;
//  * zero padding pads the *activated* tensor: halo pixels outside the
//    image are 0, not silu(shift) (_conv_taps:101 pads after the norm);
//  * channels past Cin (a ragged last chunk, e.g. 960 = 15 x 64) are zero
//    in both operands; Cin and Cout must be multiples of 8 (bf16) or 32
//    (W8A8: whole 32-byte k steps);
//  * the weights arrive packed [Cout, 3, 3, Cin] (OHWI, one tap's channels
//    contiguous) and are staged one tap at a time;
//  * 4 warps, each a [32 pixel x 64 channel] warp tile of mma.sync:
//    m16n8k16 bf16 -> fp32, or m16n8k32 s8 -> s32.  A k step is 32 bytes
//    of a tile row in both, so the two variants share every address: a
//    tile row is 64 channels plus 16 bytes of padding;
//  * W8A8 dequantizes once per output, acc * (sx * w_scale[c]) in fp32,
//    where the Pallas kernel dequantizes each tap's s32 product before
//    summing (_conv_taps:110-112): the two differ only in fp32 summation
//    order.  9 * 2560 * 127^2 < 2^31, so the s32 sum cannot overflow at
//    SD's widths.
// No TMA, wgmma or pipelining yet: that is later work.
//
// The C entry points return the CUDA error of the launch (0 on success),
// or -1 for arguments the kernel does not take; the Python wrapper raises
// on anything but 0.

#include "mma_tiles.cuh"

namespace {

constexpr int kBM = 128;       // output pixels per block
constexpr int kBN = 64;        // output channels per block
constexpr int kBK = 64;        // input channels per chunk
constexpr int kThreads = 128;  // 4 warps x 32 pixels

// element and accumulator types of the two variants, and the bytes of one
// row of the halo / weight tiles: 64 channels + 16 padding
template <bool Q8> struct Variant {
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int kRow = kBK * 2 + 16;
};
template <> struct Variant<true> {
  using T = int8_t;
  using Acc = int;
  static constexpr int kRow = kBK + 16;
};

struct ConvArgs {
  const __nv_bfloat16* x;   // [B, H, W, Cin] input (conv1: x, conv2: h)
  const float* mean;        // [B, G] group statistics of x
  const float* rstd;        // [B, G]
  const float* gamma;       // [Cin] GroupNorm scale
  const float* beta;        // [Cin] GroupNorm shift
  const void* w;            // [Cout, 3, 3, Cin] bf16 or int8
  const float* w_scale;     // [Cout] per-channel weight scale (W8A8)
  const float* act_scale;   // [1] static activation scale sx (W8A8)
  const float* bias;        // [Cout]
  const float* tvec;        // [B, Cout] or null: time-embedding projection
  const __nv_bfloat16* resid;  // [B, H, W, Cout] or null: shortcut
  __nv_bfloat16* out;       // [B, H, W, Cout]
  float* psum;              // [B, n_tiles, Cout] or null: GN2 partial sums
  float* psq;               // [B, n_tiles, Cout] or null: ... of squares
  int H, W, Cin, Cout, G;
};

template <int TW, bool Q8>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs a) {
  using T = typename Variant<Q8>::T;
  using Acc = typename Variant<Q8>::Acc;
  constexpr int TH = kBM / TW;
  constexpr int HW_ = TW + 2;             // halo width
  constexpr int HP = (TH + 2) * HW_;      // halo pixels
  constexpr int kRow = Variant<Q8>::kRow;
  constexpr int kVecs = kBK * static_cast<int>(sizeof(T)) / 16;  // per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cin_a = (a.Cin + kBK - 1) / kBK * kBK;
  float* sScale = reinterpret_cast<float*>(smem_raw);
  float* sShift = sScale + cin_a;
  unsigned char* sH = reinterpret_cast<unsigned char*>(sShift + cin_a);
  unsigned char* sB = sH + HP * kRow;
  float* sRed = reinterpret_cast<float*>(sH);  // epilogue: [2][4][kBN]

  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_x = (W + TW - 1) / TW;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  // W8A8: the activation scale and its reciprocal (IEEE division, as the
  // Pallas kernel's 1.0 / sx)
  const float sx = Q8 ? *a.act_scale : 1.f;
  const float inv_sx = 1.f / sx;

  // per-channel affine of the GroupNorm for this image: y = x*k + s
  const int gsize = Cin / a.G;
  for (int c = threadIdx.x; c < cin_a; c += kThreads) {
    float k = 0.f, s = 0.f;
    if (c < Cin) {
      const int gi = b * a.G + c / gsize;
      k = a.rstd[gi] * a.gamma[c];
      s = a.beta[c] - a.mean[gi] * k;
    }
    sScale[c] = k;
    sShift[c] = s;
  }

  // this thread's four A-fragment rows (pixels) as halo byte offsets
  int hoff[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * 32 + mt * 16 + h * 8 + g;
      hoff[mt][h] = ((p / TW + 1) * HW_ + (p % TW) + 1) * kRow;
    }
  }

  Acc acc[2][kBN / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0;

  const __nv_bfloat16* xb = a.x + (long long)b * H * W * Cin;
  const T* wt = static_cast<const T*>(a.w);
  for (int c0 = 0; c0 < Cin; c0 += kBK) {
    __syncthreads();  // the previous chunk's halo and weights are consumed
    // halo: normalize + SiLU once per element (W8A8: + quantize), zeros
    // outside the image
    for (int i = threadIdx.x; i < HP * (kBK / 8); i += kThreads) {
      const int hp = i / (kBK / 8);
      const int cv = (i % (kBK / 8)) * 8;
      const int gy = ty0 + hp / HW_ - 1;
      const int gx = tx0 + hp % HW_ - 1;
      const int c = c0 + cv;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);  // 8 activated bf16 values
      __nv_bfloat16* y8 = reinterpret_cast<__nv_bfloat16*>(&val);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            xb + ((long long)gy * W + gx) * Cin + c);
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float y = __bfloat162float(v[q]) * sScale[c + q] + sShift[c + q];
          y8[q] = __float2bfloat16(y / (1.f + __expf(-y)));
        }
      }
      unsigned char* dst = sH + hp * kRow + cv * static_cast<int>(sizeof(T));
      if constexpr (Q8) {  // zeros stay 0
        uint2 qv;
        int8_t* o = reinterpret_cast<int8_t*>(&qv);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int r = __float2int_rn(__bfloat162float(y8[q]) * inv_sx);
          o[q] = static_cast<int8_t>(max(-127, min(127, r)));
        }
        *reinterpret_cast<uint2*>(dst) = qv;
      } else {
        *reinterpret_cast<uint4*>(dst) = val;
      }
    }

    for (int tap = 0; tap < 9; ++tap) {
      if (tap > 0) __syncthreads();  // the previous tap's weights are consumed
      for (int i = threadIdx.x; i < kBN * kVecs; i += kThreads) {
        const int r = i / kVecs;
        const int cv = (i % kVecs) * (16 / static_cast<int>(sizeof(T)));
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + r < Cout && c0 + cv < Cin) {
          val = *reinterpret_cast<const uint4*>(
              wt + ((long long)(n0 + r) * 9 + tap) * Cin + c0 + cv);
        }
        *reinterpret_cast<uint4*>(sB + r * kRow +
                                  cv * static_cast<int>(sizeof(T))) = val;
      }
      __syncthreads();
      const int shift = ((tap / 3 - 1) * HW_ + (tap % 3 - 1)) * kRow;
#pragma unroll
      for (int kb = 0; kb < kBK * static_cast<int>(sizeof(T)); kb += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const unsigned char* p0 = sH + hoff[mt][0] + shift + kb + t * 4;
          const unsigned char* p1 = sH + hoff[mt][1] + shift + kb + t * 4;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
        }
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          uint32_t bf[2];
          const unsigned char* br = sB + (j * 8 + g) * kRow + kb + t * 4;
          bf[0] = *reinterpret_cast<const uint32_t*>(br);
          bf[1] = *reinterpret_cast<const uint32_t*>(br + 16);
          if constexpr (Q8) {
            vt::mma_16832_s8(acc[0][j], af[0], bf);
            vt::mma_16832_s8(acc[1][j], af[1], bf);
          } else {
            vt::mma_16816(acc[0][j], af[0], bf);
            vt::mma_16816(acc[1][j], af[1], bf);
          }
        }
      }
    }
  }

  // epilogue: (W8A8: dequantize) +bias (+tvec) (+shortcut), store bf16,
  // GN2 partial sums
  float csum[kBN / 8][2], csq[kBN / 8][2];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) csum[j][0] = csum[j][1] = csq[j][0] = csq[j][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = warp * 32 + mt * 16 + h * 8 + g;
      const int y = ty0 + p / TW;
      const int x = tx0 + p % TW;
      if (y >= H || x >= W) continue;
      const long long pix = ((long long)b * H + y) * W + x;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + j * 8 + t * 2;
        if (col >= Cout) continue;  // Cout is even: col + 1 < Cout too
        float v0 = static_cast<float>(acc[mt][j][h * 2]);
        float v1 = static_cast<float>(acc[mt][j][h * 2 + 1]);
        if constexpr (Q8) {
          v0 *= sx * a.w_scale[col];
          v1 *= sx * a.w_scale[col + 1];
        }
        v0 += a.bias[col];
        v1 += a.bias[col + 1];
        if (a.tvec != nullptr) {
          v0 += a.tvec[b * Cout + col];
          v1 += a.tvec[b * Cout + col + 1];
        }
        if (a.resid != nullptr) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              a.resid + pix * Cout + col);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + pix * Cout + col) =
            __floats2bfloat162_rn(v0, v1);
        csum[j][0] += v0;
        csum[j][1] += v1;
        csq[j][0] += v0 * v0;
        csq[j][1] += v1 * v1;
      }
    }
  }
  if (a.psum == nullptr) return;

  // reduce over the 8 row groups of the warp, then over the 4 warps in a
  // fixed order
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        csum[j][e] += __shfl_xor_sync(0xffffffffu, csum[j][e], off);
        csq[j][e] += __shfl_xor_sync(0xffffffffu, csq[j][e], off);
      }
    }
  }
  __syncthreads();  // every warp is done reading the halo (sRed aliases it)
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = j * 8 + t * 2 + e;
        sRed[warp * kBN + cl] = csum[j][e];
        sRed[4 * kBN + warp * kBN + cl] = csq[j][e];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kBN && n0 + threadIdx.x < Cout) {
    const int cl = threadIdx.x;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s += sRed[w * kBN + cl];
      q += sRed[4 * kBN + w * kBN + cl];
    }
    const long long o = ((long long)b * gridDim.x + blockIdx.x) * Cout + n0 + cl;
    a.psum[o] = s;
    a.psq[o] = q;
  }
}

template <int TW, bool Q8>
int launch(const ConvArgs& a, int B, cudaStream_t stream) {
  constexpr int TH = kBM / TW;
  const int cin_a = (a.Cin + kBK - 1) / kBK * kBK;
  const size_t smem = sizeof(float) * 2 * (size_t)cin_a +
                      (size_t)((TH + 2) * (TW + 2) + kBN) * Variant<Q8>::kRow;
  auto kern = conv3x3_kernel<TW, Q8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  dim3 grid(tiles, (a.Cout + kBN - 1) / kBN, B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool Q8>
int dispatch(const ConvArgs& a, int B, int tile_w, void* stream) {
  const int align = Q8 ? 32 : 8;
  if (B <= 0 || a.H <= 0 || a.W <= 0 || a.Cin <= 0 || a.Cout <= 0 ||
      a.G <= 0 || a.Cin % align != 0 || a.Cout % align != 0 ||
      a.Cin % a.G != 0 || (a.psum == nullptr) != (a.psq == nullptr) ||
      (Q8 && (a.w_scale == nullptr || a.act_scale == nullptr))) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_w) {
    case 8: return launch<8, Q8>(a, B, s);
    case 16: return launch<16, Q8>(a, B, s);
    case 32: return launch<32, Q8>(a, B, s);
    default: return -1;
  }
}

}  // namespace

// One 3x3 convolution (stride 1, zero padding 1) of silu(groupnorm(x)),
// W8A8, see the file note: int8 weights w [Cout, 3, 3, Cin] with fp32
// per-channel scales w_scale [Cout], the activation quantized in the
// prologue with the static scale act_scale [1]; Cin and Cout multiples of
// 32.  tile_w (8, 16 or 32) is the pixel tile's width; the GN2 partials,
// when asked for, are [B, ceil(H/(128/tile_w)) * ceil(W/tile_w), Cout].
// Returns 0 on success, a cudaError_t code, or -1 for arguments the kernel
// does not take.
extern "C" int vidtome_resnet_conv3x3_w8a8(
    const void* x, const float* mean, const float* rstd, const float* gamma,
    const float* beta, const float* act_scale, const void* w,
    const float* w_scale, const float* bias, const float* tvec,
    const void* resid, void* out, float* psum, float* psq, int B, int H,
    int W, int Cin, int Cout, int G, int tile_w, void* stream) {
  ConvArgs a{static_cast<const __nv_bfloat16*>(x), mean, rstd, gamma, beta,
             w, w_scale, act_scale, bias, tvec,
             static_cast<const __nv_bfloat16*>(resid),
             static_cast<__nv_bfloat16*>(out), psum, psq, H, W, Cin, Cout, G};
  return dispatch<true>(a, B, tile_w, stream);
}
