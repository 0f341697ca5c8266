// The W8A8 3x3 convolution of a fused ResnetBlock2D for Hopper (sm_90a):
// bf16 activations in, int8 weights and activations, s32 sums, bf16 out.
//
// Replaces the convolution work of vidtome_tpu/ops/resnet.py:fused_resnet
// with quant=True (its two pallas_calls: _kernel_a, GN1 normalize+SiLU ->
// quantize -> conv1 -> +b1+temb -> GN2 statistics; _kernel_b, GN2
// normalize+SiLU -> quantize -> conv2 -> +b2 +shortcut; the taps in
// _conv_taps, the quantization in _act_q).  ops/resnet.py drives the block
// as it drives the bf16 one (csrc/resnet_bf16.cu), whose design this
// follows with int8 operands:
//   1. GN1 statistics of x;
//   2. conv3x3 (this file): the GN1 normalize+SiLU, rounded to bf16 and
//      quantized with the static post-norm scale sx, as the input is
//      staged; s32 products; dequantized once an output, +b1+tvec, h
//      stored bf16, and per-tile fp32 GN2 partials of h before rounding;
//   3. GN2 statistics from those partials, reduced in a fixed order;
//   4. conv3x3 (this file) with the GN2 prologue and +b2 +shortcut.
//
// What bounds it on the H100: not the products (2*H*W*9*Cin*Cout int8
// operations an image: 60 G for conv1 at [8,64,64,320], 0.031 ms at 1979
// TOP/s) but the per-element normalize + SiLU + quantize of the input (a
// tanh each) and the epilogue, which cost what they cost in the bf16
// kernel while the products take half the time (PERF.md: at L0 conv1 the
// products with chunk 0's halo and the epilogue took 0.10 ms of 0.17).
// So the design spends products to save activation:
//  * implicit GEMM on s8 wgmma (m64nNk32, s32 sums): M = the 64 pixels of
//    an 8 x 8 tile of one image, N = NW x BN output channels (two consumer
//    warpgroups of 160 side by side, or one of 64 where the grid is small),
//    K = 9 taps x Cin in chunks of 128 channels.  Every warpgroup reads the
//    same activated halo: a 10 x 10 halo serves 320 output channels, where
//    the bf16 kernel's 16 x 8 tile (an 18 x 10 halo) serves 160; each
//    input element is activated Cout / 320 times.  s8 wgmma takes both
//    operands K-major, as the packed weight [Cout, 3, 3, Cin] and the halo
//    planes are;
//  * B, the weights, by TMA through a ring of (chunk, tap) tiles with full
//    / empty mbarriers, issued by one thread of a producer warpgroup that
//    runs ahead across taps and chunks, NW boxes of BN rows a tile: a 4-D
//    map of dims (Cin, 9, Cout, 1) over the int8 storage (hopper.cuh,
//    encode_conv_weights), so a ragged last chunk reads zeros past Cin,
//    never the next tap's channels.  A box is BN rows of 128 bytes in
//    128-byte swizzle, the bf16 kernel's bytes;
//  * registers: the card allocates a block's registers by whole
//    warpgroups (a block of 288 threads at 196 a thread failed to launch),
//    so the producer is a warpgroup, and at NW = 2 setmaxnreg moves all but
//    40 of its registers a thread to the consumers (232 each): their
//    accumulators and the next chunk's halo loads do not spill;
//  * A, the activated input, from shared memory: per chunk the consumers
//    stage the 10 x 10 halo once -- normalized, activated in fp32, rounded
//    to bf16, multiplied by 1 / sx, rounded half to even and clamped to
//    +-127 (_norm_silu, _act_q) -- without swizzle, as 8 planes of 16 int8
//    channels, each plane one 16-byte row a halo pixel.  Every tap's A is
//    then a descriptor at an offset of the same halo (rows of 8 pixels SBO
//    = 10 pixels apart, the two planes of a k32 step LBO apart).  A from
//    registers would serialize the wgmmas (resnet_bf16.cu);
//  * a ragged last chunk (SD's 320 and 960 channels are 2.5 and 7.5
//    chunks) runs all four k32 steps: past Cin both operands are zeros
//    (TMA's fill, the halo's), and skipping those steps measured slower
//    than the products it saves (a wgmma under a runtime predicate);
//  * zero padding pads the activated tensor: halo pixels outside the image
//    are 0, as are channels past Cin;
//  * three halo buffers: the next chunk's halo is loaded at the chunk's
//    start and activated a slice a tap while the products run, into the
//    buffer whose products are two chunks back and done; the barrier that
//    publishes it sits mid-chunk, with products in flight;
//  * epilogue from registers: acc * (sx * w_scale[c]) in fp32, once an
//    output (the Pallas kernel dequantizes each tap's product before
//    summing, _conv_taps:110-112: the two differ in fp32 summation order
//    only), +bias (+tvec) (+shortcut), bf16 stores, and the GN2 partials
//    of the fp32 values reduced across the warps in a fixed order (no
//    atomics).  9 * 2560 * 127^2 < 2^31, so the s32 sums cannot overflow
//    at SD's widths.
// The consumer warpgroups and N are the caller's choice
// (ops/resnet.conv_plan_w8a8 picks them from the grid), passed as `tile` =
// consumer warpgroups | output channels a block << 8.
//
// The C entry returns the CUDA error of the launch (0 on success), -1 for
// arguments the kernel does not take, -2 when the driver has no
// cuTensorMapEncodeTiled and -3 when it refuses the map; the Python
// wrapper raises on anything but 0.

#include "hopper.cuh"

namespace {

constexpr int kBK = 128;  // int8 channels a chunk: one swizzle row of B
constexpr int kT = 8;     // the pixel tile: 8 x 8, one 64-row A
constexpr int kHWD = kT + 2;  // halo width
constexpr int kStages = 4;    // the weight ring
constexpr int kProducerRegs = 40;  // a producer thread's after setmaxnreg

// Per instance: NW consumer warpgroups side by side along the output
// channels, BN each.
template <int NW, int BN>
struct Tile {
  static constexpr int HP = kHWD * kHWD;  // halo pixels
  static constexpr int CONSUMERS = 128 * NW;
  static constexpr int THREADS = CONSUMERS + 128;  // + the producer
  // halo items (8 channels of one halo pixel: half a plane row) each
  // consumer thread stages a chunk, PER_TAP of them a tap from tap 1 to
  // LAST_TAP
  static constexpr int ITEMS = (HP * 16 + CONSUMERS - 1) / CONSUMERS;
  static constexpr int PER_TAP = (ITEMS + 7) / 8;
  static constexpr int LAST_TAP = (ITEMS + PER_TAP - 1) / PER_TAP;
  // one (chunk, tap) tile: NW boxes of BN rows
  static constexpr uint32_t B_BYTES = NW * BN * 128;
  // one 16-channel plane of the halo: 16 bytes a pixel, an odd number of
  // rows (the 8 planes' rows of one pixel fall in 8 different bank groups)
  static constexpr uint32_t PLANE = (HP | 1) * 16;
  static constexpr uint32_t HALO_BYTES = 8 * PLANE;
  static constexpr uint32_t HALO_OFF = kStages * B_BYTES;
  static constexpr uint32_t BAR_OFF = HALO_OFF + 3 * HALO_BYTES;
  // + full and empty barriers, + slack to align the base to 1024 bytes
  static constexpr size_t SMEM = BAR_OFF + 16 * kStages + 1024;
  static_assert(B_BYTES % 1024 == 0, "ring stages keep the swizzle span");
  static_assert(2 * 4 * NW * BN * 4 <= 3 * HALO_BYTES,
                "the epilogue's reduction fits in the halo buffers");
  // setmaxnreg hands the producer's registers to the consumers where the
  // block holds its SM alone (its shared memory takes over half), so no
  // other block's warps wait on them; a consumer thread then has what the
  // producer leaves of the SM's 64K
  static constexpr bool MOVE_REGS = SMEM > 232448 / 2;
  static constexpr int CONSUMER_REGS =
      (65536 - 128 * kProducerRegs) / CONSUMERS / 8 * 8;
  static_assert(!MOVE_REGS || CONSUMER_REGS <= 256, "setmaxnreg's range");
};

struct ConvArgs {
  const __nv_bfloat16* x;   // [B, H, W, Cin] input (conv1: x, conv2: h)
  const float* mean;        // [B, G] group statistics of x
  const float* rstd;        // [B, G]
  const float* gamma;       // [Cin] GroupNorm scale
  const float* beta;        // [Cin] GroupNorm shift
  const float* act_scale;   // [1] static activation scale sx
  const float* w_scale;     // [Cout] per-channel weight scale
  const float* bias;        // [Cout]
  const float* tvec;        // [B, Cout] or null: time-embedding projection
  const __nv_bfloat16* resid;  // [B, H, W, Cout] or null: shortcut
  __nv_bfloat16* out;       // [B, H, W, Cout]
  float* psum;              // [B, tiles, Cout] or null: GN2 partial sums
  float* psq;               // [B, tiles, Cout] or null: ... of squares
  int H, W, Cin, Cout, G;
};

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y)
               : "memory");
}

// d[N / 2] += A B for a 64 x N tile of s8 x s8 -> s32, A and B from shared
// memory, both K-major (the only form s8 takes).
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[80], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

// One halo item: 8 channels of one halo pixel of a chunk, as loaded from x
// (valid: inside the image and below Cin).
struct HaloVec {
  uint4 raw;
  bool valid;
};

template <int NW, int BN>
__global__ void __launch_bounds__(Tile<NW, BN>::THREADS, 1)
conv3x3_w8a8_kernel(const __grid_constant__ CUtensorMap tm_w, ConvArgs a) {
  using T = Tile<NW, BN>;
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t halo = base + T::HALO_OFF;
  const uint32_t full = base + T::BAR_OFF;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * S;      // empty[s] at empty + 8 s

  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_x = (W + kT - 1) / kT;
  const int ty0 = (blockIdx.x / tiles_x) * kT;
  const int tx0 = (blockIdx.x % tiles_x) * kT;
  const int n0 = blockIdx.y * NW * BN;
  const int b = blockIdx.z;
  const int n_chunks = (Cin + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NW);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // the producer warpgroup: one thread walks the (chunk, tap) tiles in
    // the consumers' order, S ahead; a box wholly past Cout is not loaded
    // (its rows feed only columns the epilogue skips)
    if constexpr (T::MOVE_REGS) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    }
    if (tid == T::CONSUMERS) {
      const int boxes = min(NW, (Cout - n0 + BN - 1) / BN);
      const int n_tiles = 9 * n_chunks;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, boxes * BN * 128);
        for (int j = 0; j < boxes; ++j) {
          tma_load(ring + s * T::B_BYTES + j * BN * 128, &tm_w, full + 8 * s,
                   (i / 9) * kBK, i % 9, n0 + j * BN, 0);
        }
      }
    }
    return;
  }

  if constexpr (T::MOVE_REGS) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::CONSUMER_REGS));
  }
  const int nw = tid / 128;  // this warpgroup's output channels
  const int lane = tid % 32;
  const __nv_bfloat16* xb = a.x + (long long)b * H * W * Cin;
  const int gsize = Cin / a.G;
  const int part = tid & 15;  // this thread's 8 channels of every pixel
  const int cv = part * 8;
  // where they land in a halo buffer: plane part / 2, half part % 2 of its
  // 16-byte row
  const uint32_t st_off = (part >> 1) * T::PLANE + (part & 1) * 8;
  const float sx = *a.act_scale;
  const float inv_sx = 1.f / sx;  // IEEE division, as the plain 1.0 / sx

  // this thread's halo items: item k is item tid + k * CONSUMERS of the
  // chunk, 16 to a pixel
  auto load_vec = [&](int c0, int k) {
    HaloVec v{make_uint4(0u, 0u, 0u, 0u), false};
    const int idx = tid + k * T::CONSUMERS;
    if (idx < T::HP * 16) {
      const int hp = idx >> 4;
      const int gy = ty0 + hp / kHWD - 1;
      const int gx = tx0 + hp % kHWD - 1;
      const int c = c0 + cv;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin) {
        v.raw = *reinterpret_cast<const uint4*>(
            xb + ((long long)gy * W + gx) * Cin + c);
        v.valid = true;
      }
    }
    return v;
  };
  // normalize + SiLU in fp32 (y = x * k + s; silu(y) = h + h tanh(h) with
  // h = y / 2 = x * (k / 2) + s / 2, one special-function op), round to
  // bf16, then the int8 code round(a / sx) to nearest even, clamped to
  // +-127.  Clamped first (to the integer 127: the same code), a / sx +
  // 1.5 * 2^23 holds the code in its low mantissa byte, rounded by the
  // add as the plain version rounds: no float-to-int conversion, which
  // issues at a quarter of the rate of the adds
  auto store_vec = [&](uint32_t hbuf, int k, const HaloVec& v,
                       const float (&ks)[8], const float (&ss)[8]) {
    const int idx = tid + k * T::CONSUMERS;
    if (idx >= T::HP * 16) return;
    uint2 o = make_uint2(0u, 0u);
    if (v.valid) {
      const uint32_t* in = reinterpret_cast<const uint32_t*>(&v.raw);
      uint32_t pair[4];  // the codes of channels 2p, 2p + 1 in bytes 0, 1
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float h0 = fmaf(__uint_as_float(in[p] << 16), ks[2 * p],
                              ss[2 * p]);
        const float h1 = fmaf(__uint_as_float(in[p] & 0xffff0000u),
                              ks[2 * p + 1], ss[2 * p + 1]);
        const uint32_t act = pack_bf16(fmaf(h0, tanh_approx(h0), h0),
                                       fmaf(h1, tanh_approx(h1), h1));
        const float q0 = fminf(fmaxf(
            __fmul_rn(__uint_as_float(act << 16), inv_sx), -127.f), 127.f);
        const float q1 = fminf(fmaxf(
            __fmul_rn(__uint_as_float(act & 0xffff0000u), inv_sx), -127.f),
            127.f);
        pair[p] = __byte_perm(__float_as_uint(__fadd_rn(q0, 12582912.f)),
                              __float_as_uint(__fadd_rn(q1, 12582912.f)),
                              0x0040);
      }
      o.x = __byte_perm(pair[0], pair[1], 0x5410);
      o.y = __byte_perm(pair[2], pair[3], 0x5410);
    }
    st_shared_v2(hbuf + st_off + (idx >> 4) * 16, o);
  };
  // the GroupNorm affine of this thread's 8 channels of chunk c0, halved
  // (h = y / 2 above)
  auto affine = [&](int c0, float (&ks)[8], float (&ss)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = c0 + cv + q;
      float k = 0.f, s = 0.f;
      if (c < Cin) {
        const int gi = b * a.G + c / gsize;
        k = a.rstd[gi] * a.gamma[c];
        s = a.beta[c] - a.mean[gi] * k;
      }
      ks[q] = 0.5f * k;
      ss[q] = 0.5f * s;
    }
  };

  float ks[8], ss[8];
  {  // chunk 0's halo, all at once
    affine(0, ks, ss);
    HaloVec v[T::ITEMS];
#pragma unroll
    for (int k = 0; k < T::ITEMS; ++k) v[k] = load_vec(0, k);
#pragma unroll
    for (int k = 0; k < T::ITEMS; ++k) store_vec(halo, k, v[k], ks, ss);
  }
  fence_async_smem();  // the halo is read by wgmma (the async proxy)
  consumers_sync<T::CONSUMERS>();

  int acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
  int stage = 0;
  uint32_t phase = 0;
  int hb = 0;  // the halo buffer of chunk c, c % 3
  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t hcur = halo + hb * T::HALO_BYTES;
    const int hn = hb == 2 ? 0 : hb + 1;
    const uint32_t hnext = halo + hn * T::HALO_BYTES;
    const bool more = c + 1 < n_chunks;
    // the next chunk's halo items, all loads in flight at once; PER_TAP of
    // them are activated a tap (taps 1 .. LAST_TAP)
    HaloVec nv[T::ITEMS];
    if (more) {
      affine((c + 1) * kBK, ks, ss);
#pragma unroll
      for (int k = 0; k < T::ITEMS; ++k) nv[k] = load_vec((c + 1) * kBK, k);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      // A of tap (dy, dx): the tile's 8 rows of 8 pixels shifted by dy
      // rows and dx pixels, each row 8 consecutive 16-byte pixel rows of a
      // plane (SBO: a halo row of 10 pixels), the two planes of a k32 step
      // LBO = PLANE apart
      const uint32_t at = hcur + ((tap / 3) * kHWD + tap % 3) * 16;
      mbar_wait_warp(full + 8 * stage, phase);
      fence_regs(acc);
      wgmma_fence();
      const uint32_t bt = ring + stage * T::B_BYTES + nw * BN * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_s8(acc,
                 smem_desc(at + 2 * kk * T::PLANE, T::PLANE, kHWD * 16, 0),
                 smem_desc(bt + kk * 32, 16, 1024));
      }
      wgmma_commit();
      // a slice of the next chunk's halo while this tap's and the last
      // tap's products run, into the buffer of chunk c - 2, whose products
      // are all done
      if (more && tap >= 1 && tap <= T::LAST_TAP) {
#pragma unroll
        for (int i = 0; i < T::PER_TAP; ++i) {
          const int k = (tap - 1) * T::PER_TAP + i;
          if (k < T::ITEMS) store_vec(hnext, k, nv[k], ks, ss);
        }
        if (tap == T::LAST_TAP) {
          // the next halo is complete and visible to wgmma (the async
          // proxy) once every consumer is here; products stay in flight
          fence_async_smem();
          consumers_sync<T::CONSUMERS>();
        }
      }
      wgmma_wait_1();
      // the previous tap's products are done: its ring stage is free
      if ((c > 0 || tap > 0) && lane == 0) {
        mbar_arrive(empty + 8 * ((stage + S - 1) % S));
      }
      if (++stage == S) {
        stage = 0;
        phase ^= 1;
      }
    }
    hb = hn;
  }
  wgmma_wait_all();
  fence_regs(acc);

  // epilogue: dequantize, +bias (+tvec) (+shortcut), bf16 stores, GN2
  // partials
  const int warp = (tid / 32) % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  int pix[2];
  bool inside[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = warp * 16 + g + 8 * r;
    const int y = ty0 + pr / kT;
    const int x = tx0 + pr % kT;
    inside[r] = y < H && x < W;
    pix[r] = (b * H + y) * W + x;
  }
  // [2][NW][4 warps][BN] floats over the halo buffers: every product has
  // completed (each warpgroup waited above, then the last chunk's barrier)
  consumers_sync<T::CONSUMERS>();
  float* red = reinterpret_cast<float*>(smem_raw + (halo - smem_u32(smem_raw)));
  const int wslot = nw * 4 + warp;
  const int nb = n0 + nw * BN;  // this warpgroup's first output channel
  const bool partials = a.psum != nullptr;
  // every load first (no store in between that the compiler would have to
  // order them after), then the stores
  float v[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = nb + j * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * j + e] = 0.f;
    if (col >= Cout) continue;  // Cout is even: col + 1 < Cout too
    const float2 ws = *reinterpret_cast<const float2*>(a.w_scale + col);
    const float dq0 = sx * ws.x, dq1 = sx * ws.y;
    float2 add = *reinterpret_cast<const float2*>(a.bias + col);
    if (a.tvec != nullptr) {
      const float2 tv = *reinterpret_cast<const float2*>(a.tvec + b * Cout + col);
      add.x += tv.x;
      add.y += tv.y;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the product rounded apart, as the plain (acc * (sx * w_scale)) + b
      v[4 * j + 2 * r] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * r]), dq0)
                         + add.x;
      v[4 * j + 2 * r + 1] =
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * r + 1]), dq1) + add.y;
      if (a.resid != nullptr && inside[r]) {
        const __nv_bfloat162 rr = *reinterpret_cast<const __nv_bfloat162*>(
            a.resid + (long long)pix[r] * Cout + col);
        v[4 * j + 2 * r] += __bfloat162float(rr.x);
        v[4 * j + 2 * r + 1] += __bfloat162float(rr.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = nb + j * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    if (col < Cout) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!inside[r]) continue;
        const float v0 = v[4 * j + 2 * r];
        const float v1 = v[4 * j + 2 * r + 1];
        *reinterpret_cast<__nv_bfloat162*>(
            a.out + (long long)pix[r] * Cout + col) =
            __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
        q0 += v0 * v0;
        q1 += v1 * v1;
      }
    }
    if (partials) {
      // over the warp's 8 row groups (lanes of the same t), fixed order
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (g == 0) {
        const int cl = j * 8 + 2 * t;
        red[wslot * BN + cl] = s0;
        red[wslot * BN + cl + 1] = s1;
        red[(4 * NW + wslot) * BN + cl] = q0;
        red[(4 * NW + wslot) * BN + cl + 1] = q1;
      }
    }
  }
  if (!partials) return;
  consumers_sync<T::CONSUMERS>();
  // over the warpgroup's 4 warps, in a fixed order
  for (int cl = tid; cl < NW * BN; cl += T::CONSUMERS) {
    if (n0 + cl >= Cout) break;
    const float* rs = red + (cl / BN) * 4 * BN + cl % BN;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s += rs[w * BN];
      q += rs[(4 * NW + w) * BN];
    }
    const long long o = ((long long)b * gridDim.x + blockIdx.x) * Cout + n0 + cl;
    a.psum[o] = s;
    a.psq[o] = q;
  }
}

template <int NW, int BN>
int launch(const ConvArgs& a, const void* w, int B, cudaStream_t stream) {
  using T = Tile<NW, BN>;
  auto kern = conv3x3_w8a8_kernel<NW, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm;
  const int err = encode_conv_weights(&tm, w, a.Cin, a.Cout, BN, 1);
  if (err != 0) return err;
  const int tiles = ((a.H + kT - 1) / kT) * ((a.W + kT - 1) / kT);
  const dim3 grid(tiles, (a.Cout + NW * BN - 1) / (NW * BN), B);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(tm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// One 3x3 convolution (stride 1, zero padding 1) of silu(groupnorm(x)),
// W8A8, see the file note: int8 weights w packed [Cout, 3, 3, Cin] with
// fp32 per-channel scales w_scale [Cout], the activation quantized as it
// is staged with the static scale act_scale [1]; Cin and Cout multiples of
// 32.  `tile` is the consumer warpgroups | the output channels a block << 8
// of an 8 x 8 pixel tile: 2 | 320 << 8 (two warpgroups of 160 channels) or
// 1 | 64 << 8.  The GN2 partials, when asked for, are
// [B, ceil(H / 8) * ceil(W / 8), Cout].
// Returns 0 on success, a cudaError_t code, -1 for arguments the kernel
// does not take, -2 / -3 when no tensor map can be made.
extern "C" int vidtome_resnet_conv3x3_w8a8(
    const void* x, const float* mean, const float* rstd, const float* gamma,
    const float* beta, const float* act_scale, const void* w,
    const float* w_scale, const float* bias, const float* tvec,
    const void* resid, void* out, float* psum, float* psq, int B, int H,
    int W, int Cin, int Cout, int G, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || G <= 0 ||
      Cin % 32 != 0 || Cout % 32 != 0 || Cin % G != 0 ||
      (psum == nullptr) != (psq == nullptr) || act_scale == nullptr ||
      w_scale == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return -1;
  }
  const ConvArgs a{static_cast<const __nv_bfloat16*>(x), mean, rstd, gamma,
                   beta, act_scale, w_scale, bias, tvec,
                   static_cast<const __nv_bfloat16*>(resid),
                   static_cast<__nv_bfloat16*>(out), psum, psq, H, W, Cin,
                   Cout, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 2 | 320 << 8: return launch<2, 160>(a, w, B, s);
    case 1 | 64 << 8: return launch<1, 64>(a, w, B, s);
    default: return -1;
  }
}
