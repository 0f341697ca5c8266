// The bf16 3x3 convolution of a fused ResnetBlock2D for Hopper (sm_90a):
// bf16 activations and weights in, fp32 accumulators, bf16 out.
//
// Replaces the convolution work of vidtome_tpu/ops/resnet.py:fused_resnet
// with quant=False (its two pallas_calls: _kernel_a, GN1 normalize+SiLU ->
// conv1 -> +b1+temb -> GN2 statistics; _kernel_b, GN2 normalize+SiLU ->
// conv2 -> +b2 +shortcut).  ops/resnet.py drives the block as
//   1. GN1 statistics of x (the port's GroupNorm statistics passes);
//   2. conv3x3 (this file), the GN1 normalize+SiLU applied as the input is
//      staged, +b1+tvec in the epilogue, h stored bf16, and per-tile fp32
//      channel sums and sums of squares of h before rounding for GN2;
//   3. GN2 statistics from those partials, reduced in a fixed order;
//   4. conv3x3 (this file) with the GN2 prologue and +b2 +shortcut.
// The W8A8 variant is csrc/resnet_w8a8.cu.
//
// What bounds it on the H100: tensor-core issue (2*H*W*9*Cin*Cout
// operations an image: 60 G for conv1 at [8,64,64,320], 0.061 ms at the
// card's peak), and beside it the per-element normalize+SiLU of the input
// (a tanh each) and the epilogue.  Measured there (PERF.md): the
// products alone 0.084 ms, with the activation or the epilogue added each
// about 0.04-0.05 ms more.
// The design:
//  * implicit GEMM on wgmma: M = the pixels of an 8-wide tile of one image
//    (64 a consumer warpgroup, 8 rows of 8: 16 x 8 pixels with two
//    warpgroups, 8 x 8 with one), N = BN output channels (160 or 64), K =
//    9 taps x Cin in chunks of 64 channels;
//  * B, the weights, by TMA through a ring of (chunk, tap) tiles with full
//    / empty mbarriers, issued by one producer warp that runs ahead across
//    taps and chunks.  The packed weight [Cout, 3, 3, Cin] is a 4-D tensor
//    map of dims (Cin, 9, Cout, 1): a ragged last chunk (Cin not a
//    multiple of 64) reads zeros past Cin, never the next tap's channels,
//    as a 2-D [Cout, 9 * Cin] map would.  The tile sits K-major in
//    128-byte swizzle rows; rows past Cout read as zeros;
//  * A, the activated input, from shared memory: per chunk the consumers
//    stage the (TH + 2) x 10 halo once, normalized, activated in fp32 and
//    rounded to bf16, without swizzle, as 8 planes of 8 channels, each
//    plane one 16-byte row a halo pixel.  In that layout an 8-pixel row of
//    the tile shifted by (dy, dx) is 8 consecutive 16-byte rows, so every
//    tap's A is a descriptor at an offset of the same halo (rows of 8
//    pixels SBO = 10 pixels apart, planes LBO apart), where a 128-byte
//    swizzle would not take a one-pixel shift.  A first version took A
//    from registers (ldmatrix from the halo, wgmma with A in registers);
//    ptxas serialized its wgmmas there, since ldmatrix defined the next
//    tap's A registers while a group was in flight (PERF.md);
//  * zero padding pads the activated tensor: halo pixels outside the image
//    are 0, not silu(shift); channels past Cin are 0 in both operands;
//  * the halo is triple-buffered: the next chunk's halo is loaded (all of
//    a thread's vectors at once, at the chunk's start) and activated a
//    slice per tap while that tap's and the last tap's products run, into
//    the buffer whose products are two chunks back and done; the barrier
//    that publishes it sits mid-chunk, with products in flight.  A
//    separate activation warpgroup feeding a ring of halo buffers on
//    mbarriers measured no faster (PERF.md);
//  * one activated halo serves BN output channels: at BN = 160 each input
//    element is activated Cout / 160 times, not Cout / 64;
//  * epilogue from registers: +bias (+tvec) (+shortcut), bf16 stores, and
//    the GN2 partials reduced across the warps in a fixed order (no
//    atomics: results repeat run to run).
// The tile and BN are the caller's choice (ops/resnet.conv_plan picks
// them from the grid), passed as `tile` = consumer warpgroups | BN << 8.
//
// The C entry returns the CUDA error of the launch (0 on success), -1 for
// arguments the kernel does not take, -2 when the driver has no
// cuTensorMapEncodeTiled and -3 when it refuses the map; the Python
// wrapper raises on anything but 0.

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;  // input channels a chunk: one swizzle row of B
constexpr int kTW = 8;   // tile width: one 8-row group of A a tile row
constexpr int kHWD = kTW + 2;  // halo width

// Per instance: NWG consumer warpgroups (8 tile rows of 8 pixels each),
// BN output channels a block.
template <int NWG, int BN>
struct Tile {
  static constexpr int TH = 8 * NWG;
  static constexpr int HP = (TH + 2) * kHWD;     // halo pixels
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  // ring depth: 3 where two blocks share an SM
  static constexpr int STAGES = NWG == 1 && BN > 64 ? 3 : 4;
  // halo vectors (8 channels) each consumer thread stages a chunk
  static constexpr int ITEMS = (HP * 8 + CONSUMERS - 1) / CONSUMERS;
  static constexpr uint32_t B_BYTES = BN * 128;   // one (chunk, tap) tile
  // one 8-channel plane of the halo: 16 bytes a pixel, an odd number of
  // rows (the 8 planes' rows of one pixel fall in 8 different bank groups)
  static constexpr uint32_t PLANE = (HP | 1) * 16;
  static constexpr uint32_t HALO_BYTES = 8 * PLANE;
  static constexpr uint32_t HALO_OFF = STAGES * B_BYTES;
  static constexpr uint32_t BAR_OFF = HALO_OFF + 3 * HALO_BYTES;
  // + full and empty barriers, + slack to align the base to 1024 bytes
  static constexpr size_t SMEM = BAR_OFF + 16 * STAGES + 1024;
  static_assert(ITEMS <= 8, "a chunk's halo must stage within taps 1-8");
  static_assert(B_BYTES % 1024 == 0, "ring stages keep the swizzle span");
  static_assert(2 * 4 * NWG * BN * 4 <= 3 * HALO_BYTES,
                "the epilogue's reduction fits in the halo buffers");
};

struct ConvArgs {
  const __nv_bfloat16* x;   // [B, H, W, Cin] input (conv1: x, conv2: h)
  const float* mean;        // [B, G] group statistics of x
  const float* rstd;        // [B, G]
  const float* gamma;       // [Cin] GroupNorm scale
  const float* beta;        // [Cin] GroupNorm shift
  const float* bias;        // [Cout]
  const float* tvec;        // [B, Cout] or null: time-embedding projection
  const __nv_bfloat16* resid;  // [B, H, W, Cout] or null: shortcut
  __nv_bfloat16* out;       // [B, H, W, Cout]
  float* psum;              // [B, tiles, Cout] or null: GN2 partial sums
  float* psq;               // [B, tiles, Cout] or null: ... of squares
  int H, W, Cin, Cout, G;
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// d[N / 2] += A B for a 64 x N tile, A and B from shared memory, both
// K-major.
__device__ __forceinline__ void wgmma_ss_k(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_k(float (&d)[80], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1));
}

// One halo vector: 8 channels of one halo pixel of a chunk, as loaded from
// x (valid: inside the image and below Cin).
struct HaloVec {
  uint4 raw;
  bool valid;
};

template <int NWG, int BN>
__global__ void __launch_bounds__(Tile<NWG, BN>::THREADS, NWG == 1 ? 2 : 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap tm_w, ConvArgs a) {
  using T = Tile<NWG, BN>;
  constexpr int S = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base;
  const uint32_t halo = base + T::HALO_OFF;
  const uint32_t full = base + T::BAR_OFF;  // full[s] at full + 8 s
  const uint32_t empty = full + 8 * S;      // empty[s] at empty + 8 s

  const int H = a.H, W = a.W, Cin = a.Cin, Cout = a.Cout;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_x) * T::TH;
  const int tx0 = (blockIdx.x % tiles_x) * kTW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int n_chunks = (Cin + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {
    // the producer warp: one thread walks the (chunk, tap) tiles in the
    // consumers' order, S ahead
    if (tid == T::CONSUMERS) {
      const int n_tiles = 9 * n_chunks;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, T::B_BYTES);
        tma_load(ring + s * T::B_BYTES, &tm_w, full + 8 * s, (i / 9) * kBK,
                 i % 9, n0, 0);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32;
  const __nv_bfloat16* xb = a.x + (long long)b * H * W * Cin;
  const int gsize = Cin / a.G;
  const int plane = tid & 7;  // this thread's 8 channels of every vector
  const int cv = plane * 8;

  // this thread's halo vectors: item k is vector tid + k * CONSUMERS
  auto load_vec = [&](int c0, int k) {
    HaloVec v{make_uint4(0u, 0u, 0u, 0u), false};
    const int idx = tid + k * T::CONSUMERS;
    if (idx < T::HP * 8) {
      const int hp = idx >> 3;
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
  // h = y / 2: one special-function op, where y / (1 + exp(-y)) takes two
  // and was measured 10-14% slower), round to bf16, store
  auto store_vec = [&](uint32_t hbuf, int k, const HaloVec& v,
                       const float (&ks)[8], const float (&ss)[8]) {
    const int idx = tid + k * T::CONSUMERS;
    if (idx >= T::HP * 8) return;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (v.valid) {
      const __nv_bfloat16* in = reinterpret_cast<const __nv_bfloat16*>(&v.raw);
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int q = 0; q < 8; q += 2) {
        const float y0 = fmaf(__bfloat162float(in[q]), ks[q], ss[q]);
        const float y1 = fmaf(__bfloat162float(in[q + 1]), ks[q + 1], ss[q + 1]);
        const float h0 = 0.5f * y0, h1 = 0.5f * y1;
        op[q / 2] = pack_bf16(fmaf(h0, tanh_approx(h0), h0),
                              fmaf(h1, tanh_approx(h1), h1));
      }
    }
    st_shared_v4(hbuf + plane * T::PLANE + (idx >> 3) * 16, o);
  };
  // the GroupNorm affine of this thread's 8 channels of chunk c0
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
      ks[q] = k;
      ss[q] = s;
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

  // A of this warpgroup for tap (0, 0): its 8 tile rows of 8 pixels,
  // each row 8 consecutive 16-byte pixel rows of a plane (SBO: a halo row
  // of 10 pixels), the two planes of a k16 step LBO = PLANE apart
  const uint32_t a_off = wg * 8 * kHWD * 16;

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  int hb = 0;  // the halo buffer of chunk c, c % 3
  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t hcur = halo + hb * T::HALO_BYTES;
    const int hn = hb == 2 ? 0 : hb + 1;
    const uint32_t hnext = halo + hn * T::HALO_BYTES;
    const bool more = c + 1 < n_chunks;
    // the next chunk's halo vectors, all loads in flight at once; each is
    // activated one tap later than the last (taps 1 .. ITEMS)
    HaloVec nv[T::ITEMS];
    if (more) {
      affine((c + 1) * kBK, ks, ss);
#pragma unroll
      for (int k = 0; k < T::ITEMS; ++k) nv[k] = load_vec((c + 1) * kBK, k);
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t at =
          hcur + a_off + ((tap / 3) * kHWD + tap % 3) * 16;
      mbar_wait_warp(full + 8 * stage, phase);
      fence_regs(acc);
      wgmma_fence();
      const uint32_t bt = ring + stage * T::B_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_k(acc,
                   smem_desc(at + 2 * kk * T::PLANE, T::PLANE, kHWD * 16, 0),
                   smem_desc(bt + kk * 32, 16, 1024));
      }
      wgmma_commit();
      // a slice of the next chunk's halo while this tap's and the last
      // tap's products run, into the buffer of chunk c - 2, whose products
      // are all done
      if (more && tap >= 1 && tap <= T::ITEMS) {
        store_vec(hnext, tap - 1, nv[tap - 1], ks, ss);
        if (tap == T::ITEMS) {
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

  // epilogue: +bias (+tvec) (+shortcut), bf16 stores, GN2 partials
  const int warp = (tid / 32) % 4;
  const int g = lane >> 2;
  const int t = lane & 3;
  int pix[2];
  bool inside[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pr = wg * 64 + warp * 16 + g + 8 * r;
    const int y = ty0 + pr / kTW;
    const int x = tx0 + pr % kTW;
    inside[r] = y < H && x < W;
    pix[r] = (b * H + y) * W + x;
  }
  // [2][4 NWG warps][BN] floats over the halo buffers: every product has
  // completed (each warpgroup waited above, then the last chunk's barrier)
  consumers_sync<T::CONSUMERS>();
  float* red = reinterpret_cast<float*>(smem_raw + (halo - smem_u32(smem_raw)));
  const int wslot = wg * 4 + warp;
  const bool partials = a.psum != nullptr;
  // every load first (no store in between that the compiler would have to
  // order them after), then the stores
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    if (col >= Cout) continue;  // Cout is even: col + 1 < Cout too
    float2 add = *reinterpret_cast<const float2*>(a.bias + col);
    if (a.tvec != nullptr) {
      const float2 tv = *reinterpret_cast<const float2*>(a.tvec + b * Cout + col);
      add.x += tv.x;
      add.y += tv.y;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      acc[4 * j + 2 * r] += add.x;
      acc[4 * j + 2 * r + 1] += add.y;
      if (a.resid != nullptr && inside[r]) {
        const __nv_bfloat162 rr = *reinterpret_cast<const __nv_bfloat162*>(
            a.resid + (long long)pix[r] * Cout + col);
        acc[4 * j + 2 * r] += __bfloat162float(rr.x);
        acc[4 * j + 2 * r + 1] += __bfloat162float(rr.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * t;
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    if (col < Cout) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!inside[r]) continue;
        const float v0 = acc[4 * j + 2 * r];
        const float v1 = acc[4 * j + 2 * r + 1];
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
        red[(4 * NWG + wslot) * BN + cl] = q0;
        red[(4 * NWG + wslot) * BN + cl + 1] = q1;
      }
    }
  }
  if (!partials) return;
  consumers_sync<T::CONSUMERS>();
  // over the warps, in a fixed order
  for (int cl = tid; cl < BN; cl += T::CONSUMERS) {
    if (n0 + cl >= Cout) break;
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int w = 0; w < 4 * NWG; ++w) {
      s += red[w * BN + cl];
      q += red[(4 * NWG + w) * BN + cl];
    }
    const long long o = ((long long)b * gridDim.x + blockIdx.x) * Cout + n0 + cl;
    a.psum[o] = s;
    a.psq[o] = q;
  }
}

template <int NWG, int BN>
int launch(const ConvArgs& a, const void* w, int B, cudaStream_t stream) {
  using T = Tile<NWG, BN>;
  auto kern = conv3x3_kernel<NWG, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tm;
  const int err = encode_conv_weights(&tm, w, a.Cin, a.Cout, BN, 2);
  if (err != 0) return err;
  const int tiles = ((a.H + T::TH - 1) / T::TH) * ((a.W + kTW - 1) / kTW);
  const dim3 grid(tiles, (a.Cout + BN - 1) / BN, B);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(tm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// One 3x3 convolution (stride 1, zero padding 1) of silu(groupnorm(x)),
// bf16 weights packed [Cout, 3, 3, Cin], see the file note.  `tile` is the
// consumer warpgroups (2: a 16 x 8 pixel tile, 1: 8 x 8) | the output
// channels a block (160 or 64) << 8; the GN2 partials, when asked for, are
// [B, ceil(H / (8 * warpgroups)) * ceil(W / 8), Cout].  Returns 0 on
// success, a cudaError_t code, -1 for arguments the kernel does not take,
// -2 / -3 when no tensor map can be made.
extern "C" int vidtome_resnet_conv3x3(
    const void* x, const float* mean, const float* rstd, const float* gamma,
    const float* beta, const void* w, const float* bias, const float* tvec,
    const void* resid, void* out, float* psum, float* psq, int B, int H,
    int W, int Cin, int Cout, int G, int tile, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || G <= 0 ||
      Cin % 8 != 0 || Cout % 8 != 0 || Cin % G != 0 ||
      (psum == nullptr) != (psq == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return -1;
  }
  const ConvArgs a{static_cast<const __nv_bfloat16*>(x), mean, rstd, gamma,
                   beta, bias, tvec, static_cast<const __nv_bfloat16*>(resid),
                   static_cast<__nv_bfloat16*>(out), psum, psq, H, W, Cin,
                   Cout, G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 2 | 160 << 8: return launch<2, 160>(a, w, B, s);
    case 2 | 64 << 8: return launch<2, 64>(a, w, B, s);
    case 1 | 160 << 8: return launch<1, 160>(a, w, B, s);
    case 1 | 64 << 8: return launch<1, 64>(a, w, B, s);
    default: return -1;
  }
}
